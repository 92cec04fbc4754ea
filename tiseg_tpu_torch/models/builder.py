"""Model registries and builders (port of tiseg_tpu/models/builder.py)."""
from ..utils.registry import Registry

BACKBONES = Registry('backbone')
HEADS = Registry('head')
LOSSES = Registry('loss')
SEGMENTORS = Registry('segmentor')


def build_backbone(cfg, **default_args):
    return BACKBONES.build(cfg, default_args or None)


def build_head(cfg, **default_args):
    return HEADS.build(cfg, default_args or None)


def build_loss(cfg, **default_args):
    return LOSSES.build(cfg, default_args or None)


def build_segmentor(cfg, **default_args):
    """Build a segmentor from ``cfg.model`` (type + num_classes +
    train_cfg/test_cfg); ``default_args`` such as ``device`` fill in."""
    cfg = dict(cfg)
    cfg.setdefault('train_cfg', {})
    cfg.setdefault('test_cfg', {})
    return SEGMENTORS.build(cfg, default_args or None)
