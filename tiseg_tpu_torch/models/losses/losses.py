"""Loss zoo (port of tiseg_tpu/models/losses/losses.py).

NHWC logits (B, H, W, C) and integer labels (B, H, W), as in the JAX
package; every function is differentiable with autograd and computes in the
dtype of its float input. Per-instance reductions use sums over a static
instance-id capacity, as the JAX package's segment sums do.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..dtype import log_softmax, softmax

SMOOTH = 1e-4


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    return loss


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot; a label outside [0, num_classes) gives a row of
    zeros, as ``jax.nn.one_hot`` does (``F.one_hot`` raises)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


def _pick(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x[..., labels] per pixel (``jnp.take_along_axis`` on the last axis)."""
    return torch.gather(x, -1, labels[..., None].long())[..., 0]


def _class_weight(class_weight, labels: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(class_weight, dtype=like.dtype, device=like.device)[labels.long()]


# ---------------------------------------------------------------------------
# cross entropy family
# ---------------------------------------------------------------------------
def cross_entropy(logits, labels, weight=None, class_weight=None, reduction='mean'):
    """Per-pixel softmax CE. ``weight`` is a per-pixel map, ``class_weight``
    a (C,) vector (reference cross_entropy_loss.py:9-33)."""
    nll = -_pick(log_softmax(logits, dim=-1), labels)
    if class_weight is not None:
        nll = nll * _class_weight(class_weight, labels, nll)
    if weight is not None:
        nll = nll * weight
    return _reduce(nll, reduction)


def binary_cross_entropy(logits, labels, reduction='mean'):
    """Sigmoid BCE with integer labels expanded one-hot over channels."""
    targets = one_hot(labels, logits.shape[-1])
    loss = torch.maximum(logits, torch.zeros_like(logits)) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return _reduce(loss, reduction)


def mse_loss(pred, target, reduction='mean'):
    return _reduce((pred - target) ** 2, reduction)


# ---------------------------------------------------------------------------
# dice family
# ---------------------------------------------------------------------------
def _batch_dice_per_class(probs, labels, num_classes: int, weights):
    target = one_hot(labels, num_classes)
    inter = (probs * target).sum(dim=(0, 1, 2))
    denom = probs.sum(dim=(0, 1, 2)) + target.sum(dim=(0, 1, 2))
    per_class = 1.0 - (2 * inter + SMOOTH) / (denom + SMOOTH)
    if weights is not None:
        per_class = per_class * torch.as_tensor(weights, dtype=per_class.dtype, device=per_class.device)
    return per_class[1:].sum()


def batch_multiclass_dice_loss(logits, labels, num_classes: int, weights=None):
    """Sum over foreground classes of (1 - batch-pooled dice); softmax probs
    (reference dice_loss.py:64-100)."""
    return _batch_dice_per_class(softmax(logits, dim=-1), labels, num_classes, weights)


def batch_multiclass_sigmoid_dice_loss(logits, labels, num_classes: int, weights=None):
    return _batch_dice_per_class(torch.sigmoid(logits), labels, num_classes, weights)


def multiclass_dice_loss(logits, labels, num_classes: int, weights=None):
    """Per-image dice averaged over batch, summed over *all* classes
    (reference dice_loss.py:139-176)."""
    probs = softmax(logits, dim=-1)
    target = one_hot(labels, num_classes)
    inter = (probs * target).sum(dim=(1, 2))  # (B, C)
    denom = probs.sum(dim=(1, 2)) + target.sum(dim=(1, 2))
    dice = (2 * inter + SMOOTH) / (denom + SMOOTH)
    per_class = 1.0 - dice.sum(dim=0) / logits.shape[0]
    if weights is not None:
        per_class = per_class * torch.as_tensor(weights, dtype=per_class.dtype, device=per_class.device)
    return per_class.sum()


def _pooled_inter_add(logits, labels, num_classes: int):
    probs = softmax(logits, dim=-1)
    target = one_hot(labels, num_classes)
    return (probs * target).sum(dim=(0, 1, 2)), probs.sum(dim=(0, 1, 2)) + target.sum(dim=(0, 1, 2))


def generalized_dice_loss(logits, labels, num_classes: int):
    inter, add = _pooled_inter_add(logits, labels, num_classes)
    return 1.0 - (2 * inter.sum() + SMOOTH) / (add.sum() + SMOOTH)


def dice_loss(logits, labels, num_classes: int):
    inter, add = _pooled_inter_add(logits, labels, num_classes)
    return 1.0 - ((2 * inter + SMOOTH) / (add + SMOOTH)).mean()


# ---------------------------------------------------------------------------
# focal
# ---------------------------------------------------------------------------
def focal_loss(logits, labels, gamma: float = 2.0, class_weight=None, loss_type='softmax', robust: bool = False):
    """Softmax/sigmoid focal loss; ``robust`` clamps the focusing factor to
    [0, 2] (reference focal_loss.py:6-100, RobustFocalLoss2d)."""
    if loss_type == 'softmax':
        p_t = _pick(softmax(logits, dim=-1), labels)
    else:
        prob = torch.sigmoid(logits[..., 0] if logits.dim() == labels.dim() + 1 else logits)
        p_t = torch.where(labels > 0, prob, 1 - prob)
    p_t = p_t.clamp(1e-8, 1 - 1e-8)
    focus = (1 - p_t) ** gamma
    if robust:
        focus = focus.clamp(0.0, 2.0)
    w = 1.0 if class_weight is None else _class_weight(class_weight, labels, p_t)
    return (-w * focus * torch.log(p_t)).mean()


def one_hot2dist(class_map: np.ndarray, num_classes: int):
    """Host-side signed distance maps per class for the surface loss
    (reference surface_loss.py: one_hot2dist): negative inside the class
    region, positive outside."""
    from scipy import ndimage
    out = np.zeros((num_classes, *class_map.shape), np.float32)
    for c in range(num_classes):
        pos = class_map == c
        if pos.any():
            neg_d = ndimage.distance_transform_edt(~pos)
            pos_d = ndimage.distance_transform_edt(pos)
            out[c] = neg_d * (~pos) - (pos_d - 1) * pos
    return out


def surface_loss(probs, dist_maps, idc=(1, 2)):
    """Boundary (surface) loss: mean of probs x signed GT distance over the
    selected foreground classes (reference surface_loss.py:80-118).
    probs: (B, H, W, C) simplex; dist_maps: (B, H, W, C) from one_hot2dist.
    """
    sel = torch.as_tensor(idc, device=probs.device)
    return (probs[..., sel] * dist_maps[..., sel]).mean()


# ---------------------------------------------------------------------------
# HoVer gradient MSE (msge)
# ---------------------------------------------------------------------------
def _hv_sobel_kernel(size: int = 5, dtype=torch.float32, device=None):
    r = torch.arange(-(size // 2), size // 2 + 1, dtype=dtype, device=device)
    h, v = torch.meshgrid(r, r, indexing='ij')
    kh = h / (h * h + v * v + 1e-15)
    kv = v / (h * h + v * v + 1e-15)
    return kh, kv


def gradient_mse_loss(pred_hv, true_hv, focus):
    """Masked MSE of HV-map gradients (reference hover_loss.py:6-78).

    pred/true: (B, H, W, 2) with [..., 0]=horizontal, [..., 1]=vertical;
    focus: (B, H, W) nuclei mask. The Sobel kernel is computed in the
    prediction's dtype, as the JAX package's (float64 under x64).
    """
    kh, kv = _hv_sobel_kernel(5, pred_hv.dtype, pred_hv.device)

    def _grad(x, k):  # (B, H, W) 5x5 cross-correlation, zero padding
        return F.conv2d(x[:, None], k.to(x.dtype)[None, None], padding=2)[:, 0]

    tg = torch.stack([_grad(true_hv[..., 0], kh), _grad(true_hv[..., 1], kv)], dim=-1)
    pg = torch.stack([_grad(pred_hv[..., 0], kh), _grad(pred_hv[..., 1], kv)], dim=-1)
    focus2 = torch.stack([focus, focus], dim=-1).to(torch.float32)
    loss = focus2 * (pg - tg) ** 2
    return loss.sum() / (focus2.sum() + 1e-8)


def masked_mse_loss(pred, target, focus):
    """Sum of the masked squared error over the mask's pixel count. A
    per-pixel mask of a multi-channel ``pred`` is broadcast over the
    channels, and the channel count does not enter the denominator: the JAX
    function tests for that case after broadcasting, so its channel factor
    is always 1."""
    focus = focus.to(torch.float32)
    if pred.dim() == focus.dim() + 1:
        focus = focus[..., None]
    loss = focus * (pred - target) ** 2
    return loss.sum() / (focus.sum() + 1e-8)


# ---------------------------------------------------------------------------
# active contour / level set / variance / topological
# ---------------------------------------------------------------------------
def active_contour_loss(probs, target, area_weight=1e-6, len_weight=0.0, w_area=False):
    """probs/target: (B, H, W, C) in [0, 1] (reference ac_loss.py:16-61)."""

    def _edges(x):
        dr = (x[:, 1:, :, :] - x[:, :-1, :, :])[:, 1:, :-2, :] ** 2
        dc = (x[:, :, 1:, :] - x[:, :, :-1, :])[:, :-2, 1:, :] ** 2
        return (dr + dc).abs()

    eps = 1e-8
    length = ((torch.sqrt(_edges(probs) + eps) - torch.sqrt(_edges(target) + eps)) ** 2).mean()
    region_in = (probs * (target - 1.0) ** 2).mean()
    region_out = ((1 - probs) * target ** 2).mean()
    loss = len_weight * length + region_in + region_out
    if w_area:
        loss = loss + area_weight * probs.sum()
    return loss


def levelset_loss(mask_scores, norm_img, class_weight=1.0, levelset_evo_weight=1e-6, length_weight=1e-8):
    """mask_scores: (B, H, W, C) probabilities; norm_img: (B, H, W, C_img)
    (reference level_set_loss.py:8-100)."""
    region = 0.0
    for i in range(norm_img.shape[-1]):
        im = norm_img[..., i:i + 1]  # (B, H, W, 1)
        avg = (im * mask_scores).sum(dim=(1, 2)) / (mask_scores.sum(dim=(1, 2)) + 1e-8)
        lvl = im - avg[:, None, None, :]
        region = region + (class_weight * lvl * lvl * mask_scores).sum()
    gh = (mask_scores[:, 1:, :, :] - mask_scores[:, :-1, :, :]).abs()
    gw = (mask_scores[:, :, 1:, :] - mask_scores[:, :, :-1, :]).abs()
    length = (class_weight * gh).sum() + (class_weight * gw).sum()
    return levelset_evo_weight * region + length_weight * length


def variance_loss(logits, inst_gt, max_instances: int = 256):
    """Intra-instance variance of softmax probabilities (reference
    var_loss.py:9-36), via sums over a static id capacity: ids at or above
    ``max_instances - 1`` share the last slot, as in the JAX package."""
    probs = softmax(logits, dim=-1)  # (B, H, W, C)
    B, H, W, C = probs.shape
    ids = inst_gt.long().clamp(0, max_instances - 1).reshape(B, H * W)
    flat = probs.reshape(B, H * W, C)

    def segment_sum(x):  # (B, H*W, C) -> (B, max_instances, C)
        out = x.new_zeros(B, max_instances, x.shape[-1])
        return out.scatter_add(1, ids[..., None].expand_as(x), x)

    cnt = segment_sum(torch.ones_like(flat[..., :1]))[..., 0].to(torch.float32)
    s1, s2 = segment_sum(flat), segment_sum(flat * flat)
    n = torch.clamp(cnt, min=1.0)[..., None]
    var = (s2 - s1 * s1 / n) / torch.clamp(n - 1.0, min=1.0)  # unbiased
    foreground = torch.arange(max_instances, device=probs.device) > 0  # id 0 = background
    valid = (cnt > 1) & foreground
    sum_var = torch.where(valid[..., None], var, 0.0).sum(dim=(1, 2))
    n_inst = ((cnt > 0) & foreground).to(torch.float32).sum(dim=1)
    return (sum_var / (n_inst + 1e-8)).mean()


def topological_loss(dir_logits, dir_gt, pred_contour, target_contour, use_regression=False,
                     weight=False, num_angles: Optional[int] = None):
    """Direction consistency inside the contour band (reference
    topological_loss.py:25-110)."""
    all_contour = ((pred_contour + target_contour) > 0).to(torch.float32)
    if use_regression:
        mse = (dir_logits - dir_gt) ** 2
        if mse.dim() == all_contour.dim() + 1:
            mse = mse.mean(dim=-1)
        return (mse * all_contour).sum() / (all_contour.sum() + 1e-8)
    ce = cross_entropy(dir_logits, dir_gt, reduction='none')
    if weight:
        pred_dir = torch.argmax(dir_logits, dim=-1)
        diff = (pred_dir - dir_gt.long()).abs()
        w = torch.minimum(diff, num_angles - diff) + 1
        background = (pred_dir == 0) | (dir_gt == 0)
        ce = ce * torch.where(background, 2, w)
    return (ce * all_contour).sum() / (all_contour.sum() + 1e-8)


# ---------------------------------------------------------------------------
# training metrics (reference losses/dice.py:7-54, iou.py:7-55)
# ---------------------------------------------------------------------------
def _histc(x, num_classes):
    """float32 counts of the values 0..num_classes - 1, as
    ``jnp.bincount(length=num_classes)``: values below 0 count as 0, values
    of ``num_classes`` or more are dropped (``torch.bincount`` would grow
    its output for them). No host synchronisation."""
    x = x.reshape(-1).long().clamp(0, num_classes)  # num_classes: the slot of the dropped values
    counts = torch.zeros(num_classes + 1, dtype=torch.int64, device=x.device).scatter_add_(0, x, torch.ones_like(x))
    return counts[:num_classes].to(torch.float32)


def _areas(logits, labels, num_classes: int):
    pred = torch.argmax(logits, dim=-1)
    labels = labels.long()
    inter = _histc(torch.where(pred == labels, pred, num_classes), num_classes)
    return inter, _histc(pred, num_classes), _histc(labels, num_classes)


def tdice(logits, labels, num_classes: int):
    """Total dice over foreground classes, argmax-hardened, x100."""
    inter, area_p, area_l = (a[1:] for a in _areas(logits, labels, num_classes))
    union = area_p + area_l - inter
    return torch.nan_to_num(2 * 100 * inter.sum() / (union.sum() + inter.sum()))


def mdice(logits, labels, num_classes: int):
    """Mean per-foreground-class dice, x100."""
    inter, area_p, area_l = _areas(logits, labels, num_classes)
    dice = 2 * inter / (area_p + area_l)
    return torch.nan_to_num(100 * dice[1:].mean())


def tiou(logits, labels, num_classes: int):
    inter, area_p, area_l = (a[1:] for a in _areas(logits, labels, num_classes))
    union = area_p + area_l - inter
    return torch.nan_to_num(100 * inter.sum() / union.sum())


def miou(logits, labels, num_classes: int):
    inter, area_p, area_l = _areas(logits, labels, num_classes)
    iou = inter / (area_p + area_l - inter)
    return torch.nan_to_num(100 * iou[1:].mean())
