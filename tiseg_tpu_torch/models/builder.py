"""Model registries and builders (port of tiseg_tpu/models/builder.py)."""
from ..utils.registry import Registry

BACKBONES = Registry('backbone')
HEADS = Registry('head')
SEGMENTORS = Registry('segmentor')


def build_segmentor(cfg, **default_args):
    """Build a segmentor from ``cfg.model`` (type + num_classes +
    train_cfg/test_cfg); ``default_args`` such as ``device`` fill in."""
    cfg = dict(cfg)
    cfg.setdefault('train_cfg', {})
    cfg.setdefault('test_cfg', {})
    return SEGMENTORS.build(cfg, default_args or None)
