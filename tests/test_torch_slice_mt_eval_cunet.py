"""The ported MultiTaskCUNet eval slice vs tiseg_tpu, as in
test_torch_slice_mt_eval.py (which holds MultiTaskCDNet's, the CLI tests and
their tolerances): the JAX compile of one net takes minutes on the CPU, so
each net's slice has a file of its own for ``--dist loadfile``."""
import pytest

from torch_port_utils import (check_mt_fused_maps, check_mt_host_route, check_mt_inst_pred, check_mt_sem_pred,
                              mt_slice_run)


@pytest.fixture(scope='module', params=['MultiTaskCUNet'])
def slice_run(request):
    return mt_slice_run(request.param)


def test_fused_maps_match(slice_run):
    check_mt_fused_maps(slice_run)


def test_sem_pred_matches_and_is_not_degenerate(slice_run):
    check_mt_sem_pred(slice_run)


def test_inst_pred_bit_exact(slice_run):
    check_mt_inst_pred(slice_run)


def test_host_route(slice_run):
    """``postprocess`` (scipy) on the same fused maps gives the device
    route's canvas and, up to the numbering, its instances."""
    check_mt_host_route(slice_run)
