"""Evaluation loop (port of tiseg_tpu/apis/test.py; reference
tiseg/apis/test.py:7-105).

``single_device_test``: a batch-1 loop over a dataset. The TTA and
sliding-window inference, and with ``device_postprocess`` the instance
post-processing, run on the segmentor's device; the metric pre-eval runs
on the host, or on the device with ``device_metrics``.

``multi_process_test``: each process of an initialised ``torch.distributed``
group evaluates a disjoint stride of the dataset (DistributedSampler
analog); ``gather_object_shards`` all-gathers the per-image packages.
Without a process group both are the single-process loop.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils import get_logger
from ..utils.device import world_rank


class InferenceRunner:
    """Runs one image batch through the segmentor's eval path. When the
    segmentor supports the fused device path (inference + instance
    post-processing on the device, returning small integer maps instead of
    float logits) and ``test_cfg['device_postprocess']`` is set, that path
    is used."""

    def __init__(self, segmentor):
        self.segmentor = segmentor
        self.fused_device = (getattr(segmentor, 'device_pp_supported', False)
                             and segmentor.test_cfg.get('device_postprocess', False))

    def dispatch(self, img, ori_hw) -> Dict[str, torch.Tensor]:
        """Enqueue the device work for an NHWC batch and return its tensors
        (kernels may still be running). A numpy batch goes to a card through
        pinned memory without waiting for the work already queued there."""
        seg = self.segmentor
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.ascontiguousarray(img))
            if seg.device.type == 'cuda':
                img = img.pin_memory()
        img = img.to(seg.device, non_blocking=True)
        if self.fused_device:
            return seg.inference_and_postprocess(img, ori_hw=tuple(ori_hw))
        return seg.inference(img, ori_hw=tuple(ori_hw))

    def __call__(self, img, ori_hw) -> Dict[str, np.ndarray]:
        return {k: _numpy(v.cpu()) for k, v in self.dispatch(img, ori_hw).items()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, a bfloat16 map (numpy has no bfloat16)
    widened to float32: exact, so its argmax and ties are kept."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def fetch_later(tensors: Dict[str, torch.Tensor]) -> Callable[[], Dict[str, np.ndarray]]:
    """Enqueue the copy of ``tensors`` to the host behind the work that
    produces them, and return a function that waits for that copy alone and
    gives numpy arrays. (A blocking ``.cpu()`` waits for everything queued
    on the stream, the next image's work included.)"""
    if not any(v.is_cuda for v in tensors.values()):
        return lambda: {k: _numpy(v) for k, v in tensors.items()}
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
            for k, v in tensors.items()}
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return {k: _numpy(v) for k, v in host.items()}

    return wait


def single_device_test(segmentor, dataset, pre_eval: bool = True, show: bool = False,
                       show_folder: Optional[str] = None, indices: Optional[List[int]] = None,
                       progress: bool = True) -> List:
    """Evaluate ``segmentor`` (weights on its device) over ``dataset``, one
    image at a time: the per-image pre-eval packages (``pre_eval``, for
    ``dataset.evaluate``), or else each image's {'sem_pred', 'inst_pred'}.

    A one-item software pipeline: image n+1's device work is enqueued before
    image n's host work (post-processing, pre-eval, the next item's loading),
    so that the device computes while the host consumes. Results are
    consumed in order, as the serial loop gives them."""
    logger = get_logger()
    runner = InferenceRunner(segmentor)
    indices = list(range(len(dataset))) if indices is None else list(indices)
    device_metrics = (segmentor.test_cfg.get('device_metrics', False) and not show
                      and hasattr(dataset, 'pre_eval_device'))
    results = []

    def consume(i, fetch):
        fused = fetch()
        if runner.fused_device:
            pred = {k: v[0] for k, v in fused.items()}  # already post-processed
        else:
            pred = segmentor.postprocess({k: v[0] for k, v in fused.items()})
        if not pre_eval:
            results.append(pred)
        elif device_metrics:
            results.extend(dataset.pre_eval_device(pred, i, device=segmentor.device))
        else:
            results.extend(dataset.pre_eval(pred, i, show=show, show_folder=show_folder))

    pending = None
    for n, i in enumerate(indices):
        item = dataset[i]
        fetch = fetch_later(runner.dispatch(item['data']['img'][None], tuple(item['metas']['ori_hw'])))
        if pending is not None:
            consume(*pending)
        pending = (i, fetch)
        if progress and (n + 1) % 5 == 0:
            logger.info(f'eval [{n + 1}/{len(indices)}]')
    if pending is not None:
        consume(*pending)
    return results


def multi_process_test(segmentor, dataset, pre_eval: bool = True, show: bool = False,
                       show_folder: Optional[str] = None) -> List:
    """This process's share of the evaluation: the images ``rank::world``
    of ``dataset`` (reference multi_gpu_test, apis/test.py:47-105); merge the
    shares with :func:`gather_object_shards`."""
    world, rank = world_rank()
    indices = list(range(len(dataset)))[rank::world]
    return single_device_test(segmentor, dataset, pre_eval, show, show_folder, indices=indices)


def gather_object_shards(shard: List) -> List:
    """Every process's ``shard`` concatenated in rank order
    (``all_gather_object``); the shard itself without a process group."""
    world, _ = world_rank()
    if world == 1:
        return shard
    shards = [None] * world
    torch.distributed.all_gather_object(shards, shard)
    return [r for s in shards for r in s]
