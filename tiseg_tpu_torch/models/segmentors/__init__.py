from .base import BaseSegmentor
from .cdnet import CDNet, CDNetNet
from .cunet import CUNet, CUNetNet
from .hovernet import HoverNet, HoverNetNet
from .multi_task_cdnet import MTCDNetNet, MultiTaskCDNet, MultiTaskCDNetDebug
from .multi_task_unet import MTUNetNet, MultiTaskCUNet, MultiTaskCUNetDebug, MultiTaskUNet
from .unet import FastVGGUNetEval, UNet, UNetNet, instance_postprocess
from .unet_s2d import UNetS2D, UNetS2DNet

__all__ = ['BaseSegmentor', 'CDNet', 'CDNetNet', 'CUNet', 'CUNetNet', 'FastVGGUNetEval', 'HoverNet', 'HoverNetNet', 'MTCDNetNet', 'MTUNetNet',
           'MultiTaskCDNet', 'MultiTaskCDNetDebug', 'MultiTaskCUNet', 'MultiTaskCUNetDebug', 'MultiTaskUNet',
           'UNet', 'UNetNet', 'UNetS2D', 'UNetS2DNet', 'instance_postprocess']
