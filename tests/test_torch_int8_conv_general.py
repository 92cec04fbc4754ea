"""The general int8 convolution of the port (``ops/int8_conv.py:conv2d_i8``)
against ``lax.conv_general_dilated`` with int32 accumulation, on every
(kernel, stride, padding, groups) form the int8 executors of UNet, CDNet and
HoVer-Net pass it, bit for bit: the plain version (float64, the CPU route)
and the card's route (explicit padding, strided im2col views, block-diagonal
groups, ``torch._int_mm``), run here through the CPU's ``torch._int_mm``.
Inputs and kernels are int8 drawn over the whole range [-127, 127] (numpy,
seeded), at the executors' channel counts on small planes (odd sides where
'SAME' splits its padding unevenly)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiseg_tpu_torch.ops import int8_conv
from torch_cases import INT8_CONV_FORMS as FORMS


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8)


def _lax(x, w, stride, padding, groups):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), padding, dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        feature_group_count=groups, preferred_element_type=jnp.int32))


@pytest.mark.parametrize('name', sorted(FORMS))
def test_both_routes_bit_exact_against_lax(name):
    xs, ws, stride, padding, groups = FORMS[name]
    x, w = _int8(xs, 1), _int8(ws, 2)
    want = _lax(x, w, stride, padding, groups)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = int8_conv.conv2d_i8(xt, wt, stride, padding, groups)
    assert got.dtype == torch.int32 and want.dtype == np.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int8_conv._conv2d_i8_mm(xt, wt, stride, padding, groups).numpy(), want)


@pytest.mark.parametrize('padding', ['SAME', 'VALID', ((1, 1), (1, 1)), ((0, 1), (2, 0))])
@pytest.mark.parametrize('stride', [1, 2])
def test_conv_pads_give_lax_output_size(padding, stride):
    (pt, pb), (pl, pr) = int8_conv.conv_pads(padding, 11, 10, 3, 2, stride)
    want = _lax(np.zeros((1, 11, 10, 8), np.int8), np.zeros((3, 2, 8, 8), np.int8), stride, padding, 1).shape
    assert ((11 + pt + pb - 3) // stride + 1, (10 + pl + pr - 2) // stride + 1) == want[1:3]


def test_block_diagonal_kernel_is_the_grouped_conv():
    w = torch.from_numpy(_int8((3, 3, 8, 12), 3))
    full = int8_conv._block_diagonal(w, 4)
    assert tuple(full.shape) == (3, 3, 32, 12)
    x = torch.from_numpy(_int8((1, 6, 6, 32), 4))
    np.testing.assert_array_equal(int8_conv.conv2d_i8_plain(x, full).numpy(),
                                  int8_conv.conv2d_i8_plain(x, w, groups=4).numpy())
    assert int(full.ne(0).sum()) <= 3 * 3 * 8 * 12


def test_refusals():
    x, w = torch.from_numpy(_int8((1, 4, 4, 8), 5)), torch.from_numpy(_int8((3, 3, 8, 8), 6))
    with pytest.raises(ValueError, match='more than 16 rows'):  # 1 x 4 x 4 = 16 rows: the library refuses
        int8_conv._conv2d_i8_mm(x, w)
    with pytest.raises(ValueError, match='4 groups'):
        int8_conv.conv2d_i8(x, w, groups=4)
    with pytest.raises(TypeError, match='int8'):
        int8_conv.conv2d_i8(x.float(), w)
