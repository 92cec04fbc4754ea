"""Instance segmentation metrics: AJI, PQ (DQ/SQ), instance Dice (port of
``tiseg_tpu/utils/metrics/inst_metrics.py``, numpy and scipy only).

Semantics are the reference's (tiseg/utils/inst_metrics.py:10-626),
including its union bookkeeping: per-GT best-IoU pairing that may reuse a
prediction, unpaired GT *and* unpaired prediction areas added to the union,
and the early ``(0., 0.)`` return when either side has no instances; computed
from one O(H*W) contingency table. The on-device counterpart is
``ops/inst_metrics.py``. One difference from the JAX module:
:func:`pre_eval_to_aji` returns its 0/0 (no instance on any image) as nan
without numpy's RuntimeWarning.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..morphology import label as cc_label


def _contingency(inst_pred: np.ndarray, inst_gt: np.ndarray):
    """Re-canonicalize both maps with 8-connectivity CCL (the reference calls
    ``measure.label`` on entry, inst_metrics.py:12-13) and build the
    ``counts[g, p] = |G_g ∩ P_p|`` table including background row/col 0."""
    inst_pred = cc_label(inst_pred)
    inst_gt = cc_label(inst_gt)
    n_g = int(inst_gt.max())
    n_p = int(inst_pred.max())
    idx = inst_gt.ravel().astype(np.int64) * (n_p + 1) + inst_pred.ravel().astype(np.int64)
    counts = np.bincount(idx, minlength=(n_g + 1) * (n_p + 1)).reshape(n_g + 1, n_p + 1)
    return counts.astype(np.float64), n_g, n_p


def pre_eval_bin_aji(inst_pred: np.ndarray, inst_gt: np.ndarray) -> Tuple[float, float]:
    """Binary AJI pre-eval: returns (overall_intersection, overall_union)."""
    counts, n_g, n_p = _contingency(inst_pred, inst_gt)
    if n_g * n_p == 0:
        return 0., 0.

    gt_areas = counts.sum(axis=1)[1:]      # (n_g,)
    pred_areas = counts.sum(axis=0)[1:]    # (n_p,)
    inter = counts[1:, 1:]                 # (n_g, n_p)
    union = gt_areas[:, None] + pred_areas[None, :] - inter
    # pairs with zero overlap are "not computed" in the reference: zero union
    union = np.where(inter > 0, union, 0.0)
    iou = inter / (union + 1.0e-6)

    paired_pred = np.argmax(iou, axis=1)
    max_iou = np.max(iou, axis=1)
    paired_gt = np.nonzero(max_iou > 0.0)[0]
    paired_pred = paired_pred[paired_gt]

    overall_inter = inter[paired_gt, paired_pred].sum()
    overall_union = union[paired_gt, paired_pred].sum()

    paired_gt_ids = set(paired_gt + 1)
    paired_pred_ids = set(paired_pred + 1)
    for g in range(1, n_g + 1):
        if g not in paired_gt_ids:
            overall_union += gt_areas[g - 1]
    for p in range(1, n_p + 1):
        if p not in paired_pred_ids:
            overall_union += pred_areas[p - 1]

    return float(overall_inter), float(overall_union)


def pre_eval_bin_pq(inst_pred: np.ndarray, inst_gt: np.ndarray, match_iou: float = 0.5):
    """Binary PQ pre-eval: returns (tp, fp, fn, sum_paired_iou)."""
    assert match_iou >= 0.0, "Can't be negative"
    counts, n_g, n_p = _contingency(inst_pred, inst_gt)

    gt_areas = counts.sum(axis=1)[1:]
    pred_areas = counts.sum(axis=0)[1:]
    inter = counts[1:, 1:]
    union = gt_areas[:, None] + pred_areas[None, :] - inter
    with np.errstate(divide='ignore', invalid='ignore'):
        iou = np.where(inter > 0, inter / union, 0.0)

    if match_iou >= 0.5:
        pair_mask = iou > match_iou
        paired_gt, paired_pred = np.nonzero(pair_mask)
        paired_iou = iou[paired_gt, paired_pred]
    else:
        if n_g * n_p > 0:
            pg, pp = linear_sum_assignment(-iou)
            sel = iou[pg, pp] > match_iou
            paired_gt, paired_pred = pg[sel], pp[sel]
            paired_iou = iou[paired_gt, paired_pred]
        else:
            paired_gt = paired_pred = np.zeros(0, dtype=np.int64)
            paired_iou = np.zeros(0)

    tp = len(paired_gt)
    fp = n_p - len(set(paired_pred.tolist()))
    fn = n_g - len(set(paired_gt.tolist()))
    return tp, fp, fn, float(paired_iou.sum())


# ---------------------------------------------------------------------------
# class-wise variants (reference inst_metrics.py:95-280)
# ---------------------------------------------------------------------------
def _select_insts(inst_map: np.ndarray, id_list: List[int]) -> np.ndarray:
    out = np.zeros_like(inst_map, dtype=np.int32)
    for idx, iid in enumerate(id_list):
        out[inst_map == iid] = idx + 1
    return out


def pre_eval_aji(inst_pred, inst_gt, pred_id_list_per_class: Dict[int, List[int]],
                 gt_id_list_per_class: Dict[int, List[int]], num_classes: int,
                 reduce_zero_label: bool = True):
    union_sem_ids = sorted(set(pred_id_list_per_class) | set(gt_id_list_per_class))
    overall_inter = np.zeros(num_classes, dtype=np.float32)
    overall_union = np.zeros(num_classes, dtype=np.float32)
    for sem_id in union_sem_ids:
        if sem_id == 0:
            for pid in pred_id_list_per_class.get(sem_id, []):
                if pid != 0:
                    overall_union[sem_id] += np.sum(inst_pred == pid)
            for gid in gt_id_list_per_class.get(sem_id, []):
                if gid != 0:
                    overall_union[sem_id] += np.sum(inst_gt == gid)
            continue
        in_pred = sem_id in pred_id_list_per_class
        in_gt = sem_id in gt_id_list_per_class
        if in_pred and in_gt:
            pm = _select_insts(inst_pred, pred_id_list_per_class[sem_id])
            gm = _select_insts(inst_gt, gt_id_list_per_class[sem_id])
            i, u = pre_eval_bin_aji(pm, gm)
            overall_inter[sem_id] += i
            overall_union[sem_id] += u
        elif in_pred:
            for pid in pred_id_list_per_class[sem_id]:
                if pid != 0:
                    overall_union[sem_id] += np.sum(inst_pred == pid)
        elif in_gt:
            for gid in gt_id_list_per_class[sem_id]:
                if gid != 0:
                    overall_union[sem_id] += np.sum(inst_gt == gid)
    if reduce_zero_label:
        overall_inter = overall_inter[1:]
        overall_union = overall_union[1:]
    return overall_inter, overall_union


def pre_eval_pq(inst_pred, inst_gt, pred_id_list_per_class: Dict[int, List[int]],
                gt_id_list_per_class: Dict[int, List[int]], num_classes: int,
                reduce_zero_label: bool = True):
    union_sem_ids = sorted(set(pred_id_list_per_class) | set(gt_id_list_per_class))
    tp = np.zeros(num_classes, dtype=np.float32)
    fp = np.zeros(num_classes, dtype=np.float32)
    fn = np.zeros(num_classes, dtype=np.float32)
    iou = np.zeros(num_classes, dtype=np.float32)
    for sem_id in union_sem_ids:
        if sem_id == 0:
            fp[sem_id] += len(pred_id_list_per_class.get(sem_id, []))
            fn[sem_id] += len(gt_id_list_per_class.get(sem_id, []))
            continue
        in_pred = sem_id in pred_id_list_per_class
        in_gt = sem_id in gt_id_list_per_class
        if in_pred and in_gt:
            pm = _select_insts(inst_pred, pred_id_list_per_class[sem_id])
            gm = _select_insts(inst_gt, gt_id_list_per_class[sem_id])
            t, f, n, i = pre_eval_bin_pq(pm, gm)
            tp[sem_id] += t
            fp[sem_id] += f
            fn[sem_id] += n
            iou[sem_id] += i
        elif in_pred:
            fp[sem_id] += len(pred_id_list_per_class[sem_id])
        elif in_gt:
            fn[sem_id] += len(gt_id_list_per_class[sem_id])
    if reduce_zero_label:
        tp, fp, fn, iou = tp[1:], fp[1:], fn[1:], iou[1:]
    return tp, fp, fn, iou


# ---------------------------------------------------------------------------
# direct scores
# ---------------------------------------------------------------------------
def binary_aggregated_jaccard_index(inst_pred, inst_gt):
    i, u = pre_eval_bin_aji(inst_pred, inst_gt)
    if i == 0. or u == 0.:
        return 0.
    return i / u


def aggregated_jaccard_index(inst_pred, inst_gt, pred_id_list_per_class, gt_id_list_per_class, num_classes):
    i, u = pre_eval_aji(inst_pred, inst_gt, pred_id_list_per_class, gt_id_list_per_class, num_classes,
                        reduce_zero_label=False)
    i, u = i[1:], u[1:]
    if np.sum(i) == 0. or np.sum(u) == 0.:
        return 0.
    return np.sum(i) / np.sum(u)


def binary_panoptic_quality(inst_pred, inst_gt, match_iou=0.5):
    tp, fp, fn, iou = pre_eval_bin_pq(inst_pred, inst_gt, match_iou)
    dq = tp / (tp + 0.5 * fp + 0.5 * fn)
    sq = iou / (tp + 1.0e-6)
    return dq, sq, dq * sq


def panoptic_quality(inst_pred, inst_gt, pred_id_list_per_class, gt_id_list_per_class, num_classes, match_iou=0.5):
    tp, fp, fn, iou = pre_eval_pq(inst_pred, inst_gt, pred_id_list_per_class, gt_id_list_per_class, num_classes,
                                  reduce_zero_label=False)
    tp, fp, fn, iou = np.sum(tp[1:]), np.sum(fp[1:]), np.sum(fn[1:]), np.sum(iou[1:])
    dq = tp / (tp + 0.5 * fp + 0.5 * fn)
    sq = iou / (tp + 1.0e-6)
    return dq, sq, dq * sq


def binary_inst_dice(inst_pred, inst_gt, match_iou=0.5):
    tp, fp, fn, _ = pre_eval_bin_pq(inst_pred, inst_gt, match_iou)
    return 2 * tp / (2 * tp + fp + fn)


# ---------------------------------------------------------------------------
# reducers over lists of per-image pre-eval tuples
# ---------------------------------------------------------------------------
def _nan_wrap(ret, nan_to_num):
    if nan_to_num is not None:
        ret = OrderedDict({k: np.nan_to_num(v, nan=nan_to_num) for k, v in ret.items()})
    return ret


def pre_eval_to_bin_aji(pre_eval_results, nan_to_num=None):
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 2
    inter = sum(np.sum(x) for x in cols[0])
    union = sum(np.sum(x) for x in cols[1])
    return _nan_wrap({'Aji': inter / union}, nan_to_num)


def pre_eval_to_imw_aji(pre_eval_results, nan_to_num=None):
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 2
    ajis = np.array([np.sum(i) / np.sum(u) for i, u in zip(cols[0], cols[1])])
    return _nan_wrap({'Aji': ajis}, nan_to_num)


def pre_eval_to_aji(pre_eval_results, nan_to_num=None):
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 2
    # np.float64: 0/0 (no instance on any image) is nan, which nan_to_num
    # sanitizes, not a ZeroDivisionError, and no RuntimeWarning
    overall_inter = np.float64(sum(cols[0]))
    overall_union = np.float64(sum(cols[1]))
    with np.errstate(divide='ignore', invalid='ignore'):
        aji = overall_inter / overall_union
    return _nan_wrap({'Aji': aji}, nan_to_num)


def pre_eval_to_bin_pq(pre_eval_results, nan_to_num=None, analysis_mode=False):
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 4
    tp = sum(np.sum(x) for x in cols[0])
    fp = sum(np.sum(x) for x in cols[1])
    fn = sum(np.sum(x) for x in cols[2])
    iou = sum(np.sum(x) for x in cols[3])
    dq = tp / (tp + 0.5 * fp + 0.5 * fn)
    sq = iou / (tp + 1.0e-6)
    ret = {'DQ': dq, 'SQ': sq, 'PQ': dq * sq}
    if analysis_mode:
        ret.update({'pq_TP': tp, 'pq_FP': fp, 'pq_FN': fn, 'pq_IoU': np.round(iou, 2)})
    return _nan_wrap(ret, nan_to_num)


def pre_eval_to_imw_pq(pre_eval_results, nan_to_num=None):
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 4
    DQ, SQ, PQ = [], [], []
    for tp, fp, fn, iou in zip(*(list(map(np.sum, c)) for c in cols)):
        dq = tp / (tp + 0.5 * fp + 0.5 * fn + 1.0e-6)
        sq = iou / (tp + 1.0e-6)
        DQ.append(dq)
        SQ.append(sq)
        PQ.append(dq * sq)
    return _nan_wrap({'DQ': np.array(DQ), 'SQ': np.array(SQ), 'PQ': np.array(PQ)}, nan_to_num)


def pre_eval_to_pq(pre_eval_results, nan_to_num=None, analysis_mode=False):
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 4
    tp = sum(cols[0])
    fp = sum(cols[1])
    fn = sum(cols[2])
    iou = sum(cols[3])
    with np.errstate(divide='ignore', invalid='ignore'):
        dq = tp / (tp + 0.5 * fp + 0.5 * fn)
        sq = iou / (tp + 1.0e-6)
    ret = {'DQ': dq, 'SQ': sq, 'PQ': dq * sq}
    if analysis_mode:
        ret.update({'pq_TP': tp, 'pq_FP': fp, 'pq_FN': fn, 'pq_IoU': np.round(iou, 2)})
    return _nan_wrap(ret, nan_to_num)


def pre_eval_to_inst_dice(pre_eval_results, nan_to_num=None):
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 4
    tp = np.float64(sum(cols[0]))  # nan (not ZeroDivisionError) when all-empty
    fp = np.float64(sum(cols[1]))
    fn = np.float64(sum(cols[2]))
    return _nan_wrap({'InstDice': 2 * tp / (2 * tp + fp + fn)}, nan_to_num)


def pre_eval_to_imw_inst_dice(pre_eval_results, nan_to_num=None):
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 4
    vals = [2 * np.float64(tp) / (2 * tp + fp + fn) for tp, fp, fn in zip(cols[0], cols[1], cols[2])]
    return _nan_wrap({'InstDice': np.array(vals)}, nan_to_num)
