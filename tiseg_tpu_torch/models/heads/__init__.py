from .cd_head import AU, DGM, RU, CDHead
from .multi_task_heads import (MTDGM, MTDGMTwobranch, MultiTaskBranches, MultiTaskCDHead,
                               MultiTaskCDHeadTwobranch, MultiTaskUNetHead)
from .unet_head import UNetHead, UNetLayer

__all__ = ['AU', 'CDHead', 'DGM', 'MTDGM', 'MTDGMTwobranch', 'MultiTaskBranches', 'MultiTaskCDHead',
           'MultiTaskCDHeadTwobranch', 'MultiTaskUNetHead', 'RU', 'UNetHead', 'UNetLayer']
