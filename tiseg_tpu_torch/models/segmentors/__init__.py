from .base import BaseSegmentor
from .unet import UNet, UNetNet, instance_postprocess

__all__ = ['BaseSegmentor', 'UNet', 'UNetNet', 'instance_postprocess']
