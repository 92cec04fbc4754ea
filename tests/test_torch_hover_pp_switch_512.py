"""The plane-size switch of the port's HoVer-Net post-processing
(tiseg_tpu_torch/ops/hover.py:hover_post_proc_device): planes of at most
512*512 pixels get the bounded (4, 64) watershed (the JAX package's
MAX_VMEM_PLANE switch). The plain post-processing of a
512 x 512 plane takes minutes on the CPU, so this case has a file of its own
(it was in test_torch_hover_pp.py) and ``--dist loadfile`` gives it a
worker."""
import pytest

from torch_port_utils import check_watershed_switch


@pytest.mark.parametrize('hw,rounds', [(512, (4, 64))], ids=['512-rounds0'])
def test_watershed_follows_the_plane_size_switch(monkeypatch, hw, rounds):
    check_watershed_switch(monkeypatch, hw, rounds)
