from .builder import BACKBONES, HEADS, SEGMENTORS, build_segmentor
from .segmentors import HoverNet, HoverNetNet, UNet, UNetNet

__all__ = ['BACKBONES', 'HEADS', 'SEGMENTORS', 'build_segmentor', 'HoverNet', 'HoverNetNet', 'UNet',
           'UNetNet']
