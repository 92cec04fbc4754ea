from .base import BaseSegmentor
from .cdnet import CDNet, CDNetNet
from .cunet import CUNet, CUNetNet
from .dcan import DCAN, DCANNet
from .dist import DIST, DISTNet
from .fullnet import FullNet, FullNetNet
from .hovernet import HoverNet, HoverNetNet
from .micronet import CMicroNet, MicroNet, MicroNetNet
from .multi_task_cdnet import MTCDNetNet, MultiTaskCDNet, MultiTaskCDNetDebug
from .multi_task_unet import MTUNetNet, MultiTaskCUNet, MultiTaskCUNetDebug, MultiTaskUNet
from .unet import FastVGGUNetEval, UNet, UNetNet, instance_postprocess
from .unet_s2d import UNetS2D, UNetS2DNet

__all__ = ['BaseSegmentor', 'CDNet', 'CDNetNet', 'CMicroNet', 'CUNet', 'CUNetNet', 'DCAN', 'DCANNet', 'DIST', 'DISTNet', 'FastVGGUNetEval',
           'FullNet', 'FullNetNet', 'HoverNet', 'HoverNetNet', 'MTCDNetNet', 'MTUNetNet', 'MicroNet', 'MicroNetNet',
           'MultiTaskCDNet', 'MultiTaskCDNetDebug', 'MultiTaskCUNet', 'MultiTaskCUNetDebug', 'MultiTaskUNet',
           'UNet', 'UNetNet', 'UNetS2D', 'UNetS2DNet', 'instance_postprocess']
