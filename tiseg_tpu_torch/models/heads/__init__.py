from .unet_head import UNetHead, UNetLayer

__all__ = ['UNetHead', 'UNetLayer']
