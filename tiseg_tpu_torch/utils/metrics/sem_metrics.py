"""Semantic segmentation metrics (port of
``tiseg_tpu/utils/metrics/sem_metrics.py``, numpy only).

Same metric definitions and aggregation flavours as the reference
(tiseg/utils/sem_metrics.py:16-303): per-image pre-eval packages of per-class
(TP, TN, FP, FN, Pred, GT) histograms, reduced either dataset-pooled
(``pre_eval_to_sem_metrics`` -> the readme ``m*`` numbers) or image-wise
(``pre_eval_to_imw_sem_metrics`` -> ``imw*``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np


def _histc(values: np.ndarray, num_classes: int) -> np.ndarray:
    """torch.histc(bins=C, min=0, max=C-1) equivalent for integer labels."""
    values = np.asarray(values).ravel()
    if values.size == 0:
        return np.zeros(num_classes, dtype=np.float64)
    if num_classes == 1:
        # single bin [−0.5, 0.5]-style degenerate case: everything in range
        return np.array([float(values.size)], dtype=np.float64)
    # torch.histc bins span [min, max] with equal width; for integer labels in
    # [0, C-1] each integer falls in its own bin.
    edges = np.linspace(0, num_classes - 1, num_classes + 1)
    hist, _ = np.histogram(values.astype(np.float64), bins=edges)
    return hist.astype(np.float64)


def pre_eval_all_semantic_metric(pred_label: np.ndarray,
                                 target_label: np.ndarray,
                                 num_classes: int,
                                 ignore_index: int = 255,
                                 reduce_zero_label: bool = True) -> Tuple[np.ndarray, ...]:
    """Per-class TP/TN/FP/FN/Pred/GT histograms for one image.

    Mirrors reference tiseg/utils/sem_metrics.py:16-53 exactly (including the
    quirk that TN is computed from total *pred* pixel count).
    """
    pred_label = np.asarray(pred_label)
    target_label = np.asarray(target_label)
    mask = target_label != ignore_index
    pred_label = pred_label[mask]
    target_label = target_label[mask]

    tp_vals = target_label[pred_label == target_label]
    fp_vals = pred_label[pred_label != target_label]
    fn_vals = target_label[pred_label != target_label]

    TP = _histc(tp_vals, num_classes)
    FP = _histc(fp_vals, num_classes)
    FN = _histc(fn_vals, num_classes)
    Pred = _histc(pred_label, num_classes)
    GT = _histc(target_label, num_classes)
    TN = Pred.sum() - (TP + FP + FN)

    if reduce_zero_label:
        TP, TN, FP, FN, Pred, GT = TP[1:], TN[1:], FP[1:], FN[1:], Pred[1:], GT[1:]

    return (TP, TN, FP, FN, Pred, GT)


def intersect_and_union(pred_label, target_label, num_classes, nan_to_num=None):
    pred_label = np.asarray(pred_label)
    target_label = np.asarray(target_label)
    inter_vals = pred_label[pred_label == target_label]
    area_intersect = _histc(inter_vals, num_classes)
    area_pred = _histc(pred_label, num_classes)
    area_label = _histc(target_label, num_classes)
    area_union = area_pred + area_label - area_intersect
    with np.errstate(divide='ignore', invalid='ignore'):
        iou = area_intersect / area_union
    if nan_to_num is not None:
        iou = np.nan_to_num(iou, nan=nan_to_num)
    return iou


def accuracy(pred_label, target_label, num_classes, nan_to_num=None):
    pred_label = np.asarray(pred_label)
    target_label = np.asarray(target_label)
    TP = _histc(target_label[pred_label == target_label], num_classes)
    FP = _histc(pred_label[pred_label != target_label], num_classes)
    FN = _histc(target_label[pred_label != target_label], num_classes)
    TN = pred_label.size - (TP + FP + FN)
    with np.errstate(divide='ignore', invalid='ignore'):
        acc = (TP + TN) / pred_label.size
    return np.nan_to_num(acc, nan=nan_to_num if nan_to_num is not None else 0)


def precision_recall(pred_label, target_label, num_classes, nan_to_num=None):
    pred_label = np.asarray(pred_label)
    target_label = np.asarray(target_label)
    TP = _histc(pred_label[pred_label == target_label], num_classes)
    FP = _histc(pred_label[pred_label != target_label], num_classes)
    FN = _histc(target_label[pred_label != target_label], num_classes)
    with np.errstate(divide='ignore', invalid='ignore'):
        precision = TP / (TP + FP)
        recall = TP / (TP + FN)
    nan = nan_to_num if nan_to_num is not None else 0
    return np.nan_to_num(precision, nan=nan), np.nan_to_num(recall, nan=nan)


def dice_similarity_coefficient(pred_label, target_label, num_classes, nan_to_num=None):
    pred_label = np.asarray(pred_label)
    target_label = np.asarray(target_label)
    TP = _histc(pred_label[pred_label == target_label], num_classes)
    FP = _histc(pred_label[pred_label != target_label], num_classes)
    FN = _histc(target_label[pred_label != target_label], num_classes)
    with np.errstate(divide='ignore', invalid='ignore'):
        dice = 2 * TP / (2 * TP + FP + FN)
    return np.nan_to_num(dice, nan=nan_to_num if nan_to_num is not None else 0)


ALLOWED_METRICS = ['Accuracy', 'IoU', 'Dice', 'Recall', 'Precision']


def total_area_to_sem_metrics(TP, TN, FP, FN, Pred, GT, metrics: Sequence[str] = ('IoU',), nan_to_num=None):
    if isinstance(metrics, str):
        metrics = [metrics]
    if not set(metrics).issubset(ALLOWED_METRICS):
        raise KeyError(f'metrics {metrics} is not supported')
    ret = OrderedDict()
    with np.errstate(divide='ignore', invalid='ignore'):
        for m in metrics:
            if m == 'Accuracy':
                ret['Accuracy'] = (TP + TN) / GT.sum()
            elif m == 'IoU':
                ret['IoU'] = TP / (Pred + GT - TP)
            elif m == 'Dice':
                ret['Dice'] = 2 * TP / (Pred + GT)
            elif m == 'Recall':
                ret['Recall'] = TP / (TP + FN)
            elif m == 'Precision':
                ret['Precision'] = TP / (TP + FP)
    if nan_to_num is not None:
        ret = OrderedDict({k: np.nan_to_num(v, nan=nan_to_num) for k, v in ret.items()})
    return ret


def pre_eval_to_sem_metrics(pre_eval_results: List[Tuple], metrics: Sequence[str] = ('IoU',),
                            nan_to_num=None, beta=1):
    """Dataset-pooled per-class metrics (reference sem_metrics.py:214-245)."""
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 6
    totals = [np.sum(np.stack(c), axis=0) for c in cols]
    return total_area_to_sem_metrics(*totals, metrics=metrics, nan_to_num=nan_to_num)


def pre_eval_to_imw_sem_metrics(pre_eval_results: List[Tuple], metrics: Sequence[str] = ('IoU',),
                                nan_to_num=None):
    """Image-wise metrics: per-image class-summed scalars (reference
    sem_metrics.py:164-211)."""
    cols = tuple(zip(*pre_eval_results))
    assert len(cols) == 6
    TP_l = [np.sum(x) for x in cols[0]]
    TN_l = [np.sum(x) for x in cols[1]]
    FP_l = [np.sum(x) for x in cols[2]]
    FN_l = [np.sum(x) for x in cols[3]]
    P_l = [np.sum(x) for x in cols[4]]
    G_l = [np.sum(x) for x in cols[5]]

    ret = OrderedDict()
    with np.errstate(divide='ignore', invalid='ignore'):
        if 'Accuracy' in metrics:
            ret['Accuracy'] = np.array([(tp + tn) / g for tp, tn, g in zip(TP_l, TN_l, G_l)])
        if 'IoU' in metrics:
            ret['IoU'] = np.array([tp / (g + p - tp) for tp, p, g in zip(TP_l, P_l, G_l)])
        if 'Dice' in metrics:
            ret['Dice'] = np.array([2 * tp / (g + p) for tp, p, g in zip(TP_l, P_l, G_l)])
        if 'Recall' in metrics:
            ret['Recall'] = np.array([tp / (tp + fn) for tp, fn in zip(TP_l, FN_l)])
        if 'Precision' in metrics:
            ret['Precision'] = np.array([tp / (tp + fp) for tp, fp in zip(TP_l, FP_l)])
    if nan_to_num is not None:
        ret = OrderedDict({k: np.nan_to_num(v, nan=nan_to_num) for k, v in ret.items()})
    return ret
