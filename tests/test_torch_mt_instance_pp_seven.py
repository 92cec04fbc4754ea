"""The seven-class cases of the multi-task instance post-processing
(tiseg_tpu_torch/ops/mt_instance_pp.py) against the JAX Pallas kernel
mt_instance_postprocess_sweep in interpret mode on the CPU, with the JAX
sweep caps at 64: bit for bit on the hand-made hard planes and a plane at
CoNIC density, and what each hand-made case must give. Kept in a file of
their own (they were in test_torch_mt_instance_pp.py), since the JAX
kernel's interpret-mode run takes minutes and ``--dist loadfile`` gives a
file one worker."""
import numpy as np
import pytest

from torch_cases import mt_planes as _planes
from torch_port_utils import jax_mt_pp as _jax
from torch_port_utils import port_mt_pp as _port

HW = 96  # the planes' size (mt_planes' default)


@pytest.fixture(scope='module')
def seven():
    sem, seed = _planes()
    return sem, seed, _port(sem, seed, num_classes=7), _jax(sem, seed, num_classes=7)


def test_matches_jax_kernel_bit_exact_seven_classes(seven):
    _, _, (got_s, got_i), (want_s, want_i) = seven
    assert got_s.dtype == np.uint8 and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    assert set(np.unique(want_s)) == set(range(7))


def test_hard_plane_semantics(seven):
    """What each hand-made case must give (plane 0)."""
    sem, seed, (s, i), _ = seven
    s, i = s[0], i[0]
    lab = lambda y, x: y * HW + x + 1
    # one-pixel seed at (33, 4) in the 59 px bar: 19 waves reach column 23 and stop
    assert (i[33, 2:24] == lab(33, 4)).all() and not i[28:39, 24:61].any() and (s[28:39, 2:61] == 1).all()
    # two seeds at columns 4 and 28 meet at column 16: the larger label takes the tie
    assert (i[45, 2:16] == lab(45, 4)).all() and (i[45, 16:31] == lab(45, 28)).all()
    # a seed outside the canvas keeps its label and does not grow
    assert (i[52:54, 4:6] == lab(52, 4)).all() and not s[51:55, 3:7].any() and i[51, 4] == 0
    # canvas on the plane edge; its hole is open to the edge and stays open
    assert (s[56:60, 0:11] == 4).all() and not s[60:64, 4:6].any() and i[63, 0] == lab(58, 8)
    # 4 px object dropped from the canvas (its seed stays, alone), 5 px kept and claimed
    assert not s[52, 20:24].any() and i[52, 21] == lab(52, 21) and i[52, 20] == 0
    assert (s[54, 20:25] == 1).all() and (i[54, 20:25] == lab(54, 21)).all()
    # diagonal chain of seeds: 4-connected labelling gives three labels
    assert [i[50, 40], i[51, 41], i[52, 42]] == [lab(50, 40), lab(51, 41), lab(52, 42)]
    # size filter before the hole fill: four 1 px objects vanish, no plus appears
    assert not s[58:61, 43:46].any()
    # a class's filled hole overwrites lower classes; the speck in the class-3 hole joins the fill
    assert sem[0, 12, 12] == 2 and s[12, 12] == 5 and s[57, 30] == 3
    # growth crosses class borders of the canvas: the seed in the class-2 blob claims class-5 pixels
    assert i[12, 4] == lab(12, 12)
