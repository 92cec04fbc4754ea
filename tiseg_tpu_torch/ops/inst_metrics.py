"""On-device AJI / PQ pre-eval and the semantic confusion histograms (port of
``tiseg_tpu/ops/inst_metrics_jax.py``).

The instance contingency table is one ``bincount`` at a static capacity, and
the reductions are dense (N x N) tensor ops over it: at up to a thousand
instances per image only small vectors reach the host. Inputs must already
be labelled 1..N (:func:`relabel_sequential_device` compacts any ids); ids
beyond ``max_instances`` are clipped into the last slot, as in the JAX module.
Counts, areas, intersections and unions are integers held exactly in
float32; only the PQ's sum of paired IoUs is a float sum. The PQ pairs at
``match_iou >= 0.5``, where a pairing is unique and needs no assignment
solver; the host path (``utils/metrics``) covers lower thresholds.
"""
from __future__ import annotations

import torch


def contingency(inst_pred: torch.Tensor, inst_gt: torch.Tensor, max_instances: int = 512) -> torch.Tensor:
    """``counts[g, p] = |G_g ∩ P_p|`` with background row and column 0,
    float32 (M, M) for M = ``max_instances + 1``."""
    M = max_instances + 1
    g = inst_gt.reshape(-1).to(torch.int64).clamp(0, max_instances)
    p = inst_pred.reshape(-1).to(torch.int64).clamp(0, max_instances)
    return torch.bincount(g * M + p, minlength=M * M).reshape(M, M).to(torch.float32)


def _tables(inst_pred, inst_gt, max_instances):
    counts = contingency(inst_pred, inst_gt, max_instances)
    gt_areas = counts.sum(dim=1)[1:]
    pred_areas = counts.sum(dim=0)[1:]
    inter = counts[1:, 1:]
    return gt_areas, pred_areas, inter, gt_areas[:, None] + pred_areas[None, :] - inter


def pre_eval_bin_aji_device(inst_pred: torch.Tensor, inst_gt: torch.Tensor, max_instances: int = 512):
    """(overall_intersection, overall_union) as 0-d float32 tensors, with the
    reference's union bookkeeping (argmax-per-GT pairing that may reuse a
    prediction, unpaired GT and prediction areas added to the union; zero
    when either side is empty)."""
    gt_areas, pred_areas, inter, union = _tables(inst_pred, inst_gt, max_instances)
    zero = inter.new_zeros(())
    union = torch.where(inter > 0, union, zero)
    iou = inter / (union + 1e-6)
    gt_exists, pred_exists = gt_areas > 0, pred_areas > 0
    best_pred = iou.argmax(dim=1)  # the first maximum, as jnp.argmax
    best_iou = iou.amax(dim=1)
    paired_gt = (best_iou > 0) & gt_exists
    rows = torch.arange(inter.shape[0], device=inter.device)
    overall_inter = torch.where(paired_gt, inter[rows, best_pred], zero).sum()
    overall_union = torch.where(paired_gt, union[rows, best_pred], zero).sum()
    pred_used = torch.zeros_like(pred_exists)
    pred_used[best_pred[paired_gt]] = True
    overall_union = overall_union + torch.where(gt_exists & ~paired_gt, gt_areas, zero).sum()
    overall_union = overall_union + torch.where(pred_exists & ~pred_used, pred_areas, zero).sum()
    any_pair = gt_exists.any() & pred_exists.any()
    return torch.where(any_pair, overall_inter, zero), torch.where(any_pair, overall_union, zero)


def pre_eval_bin_pq_device(inst_pred: torch.Tensor, inst_gt: torch.Tensor, max_instances: int = 512,
                           match_iou: float = 0.5):
    """(tp, fp, fn, sum of paired IoUs) as 0-d float32 tensors, for
    ``match_iou >= 0.5`` (unique pairing)."""
    if match_iou < 0.5:
        raise ValueError('pre_eval_bin_pq_device pairs uniquely only at match_iou >= 0.5')
    gt_areas, pred_areas, inter, union = _tables(inst_pred, inst_gt, max_instances)
    zero = inter.new_zeros(())
    iou = torch.where(inter > 0, inter / torch.where(union > 0, union, torch.ones_like(union)), zero)
    pair = iou > match_iou
    tp = pair.sum()
    paired_iou = torch.where(pair, iou, zero).sum()
    fn = (gt_areas > 0).sum() - pair.any(dim=1).sum()
    fp = (pred_areas > 0).sum() - pair.any(dim=0).sum()
    return tp.float(), fp.float(), fn.float(), paired_iou


def sem_confusion_device(pred: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: int = 255):
    """Per-class (TP, TN, FP, FN, Pred, GT) float32 histograms: the
    device counterpart of ``utils/metrics/sem_metrics.pre_eval_all_semantic_metric``
    before ``reduce_zero_label``. Pixels whose target is ``ignore_index``
    count nowhere."""
    p = pred.reshape(-1).to(torch.int64)
    t = target.reshape(-1).to(torch.int64)
    ign = t == ignore_index
    p = torch.where(ign, num_classes, p)
    t = torch.where(ign, num_classes, t)
    eq = (p == t) & ~ign

    def hist(v):
        return torch.bincount(v, minlength=num_classes + 1)[:num_classes].to(torch.float32)

    TP = hist(torch.where(eq, t, num_classes))
    FP = hist(torch.where(~eq, p, num_classes))
    FN = hist(torch.where(~eq, t, num_classes))
    Pred, GT = hist(p), hist(t)
    TN = Pred.sum() - (TP + FP + FN)
    return TP, TN, FP, FN, Pred, GT


def relabel_sequential_device(inst: torch.Tensor, max_instances: int = 512) -> torch.Tensor:
    """Compact non-negative labels (e.g. the post-processing kernels'
    min-pixel-index ids) to 1..N with background 0. Beyond
    ``max_instances`` distinct ids the extras alias, as in the contingency
    table."""
    flat = torch.cat([inst.new_zeros(1, dtype=torch.int32), inst.reshape(-1).to(torch.int32)])
    ids = torch.unique(flat)[:max_instances + 1]
    fill = torch.full((max_instances + 1 - ids.numel(),), torch.iinfo(torch.int32).max, dtype=torch.int32,
                      device=inst.device)
    ids = torch.cat([ids, fill])
    return torch.searchsorted(ids, inst.to(torch.int32).contiguous()).to(torch.int32)


def pre_eval_all_device(sem_pred, inst_pred, sem_gt, inst_gt, num_classes: int, max_instances: int = 512):
    """Relabel both instance maps, then the semantic confusion, the binary
    AJI and the binary PQ pre-eval of one image, on its device."""
    ip = relabel_sequential_device(inst_pred, max_instances)
    ig = relabel_sequential_device(inst_gt, max_instances)
    sem = sem_confusion_device(sem_pred, sem_gt, num_classes)
    return sem, pre_eval_bin_aji_device(ip, ig, max_instances), pre_eval_bin_pq_device(ip, ig, max_instances)
