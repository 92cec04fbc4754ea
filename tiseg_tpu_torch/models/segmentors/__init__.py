from .base import BaseSegmentor
from .cdnet import CDNet, CDNetNet
from .hovernet import HoverNet, HoverNetNet
from .multi_task_cdnet import MTCDNetNet, MultiTaskCDNet, MultiTaskCDNetDebug
from .multi_task_unet import MTUNetNet, MultiTaskCUNet, MultiTaskCUNetDebug, MultiTaskUNet
from .unet import UNet, UNetNet, instance_postprocess

__all__ = ['BaseSegmentor', 'CDNet', 'CDNetNet', 'HoverNet', 'HoverNetNet', 'MTCDNetNet', 'MTUNetNet',
           'MultiTaskCDNet', 'MultiTaskCDNetDebug', 'MultiTaskCUNet', 'MultiTaskCUNetDebug', 'MultiTaskUNet',
           'UNet', 'UNetNet', 'instance_postprocess']
