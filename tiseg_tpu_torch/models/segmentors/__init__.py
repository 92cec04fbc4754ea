from .base import BaseSegmentor
from .hovernet import HoverNet, HoverNetNet
from .unet import UNet, UNetNet, instance_postprocess

__all__ = ['BaseSegmentor', 'HoverNet', 'HoverNetNet', 'UNet', 'UNetNet', 'instance_postprocess']
