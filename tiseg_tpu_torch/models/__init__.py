from .builder import BACKBONES, HEADS, SEGMENTORS, build_segmentor
from .segmentors import UNet, UNetNet

__all__ = ['BACKBONES', 'HEADS', 'SEGMENTORS', 'build_segmentor', 'UNet', 'UNetNet']
