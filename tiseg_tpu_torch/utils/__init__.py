from .config import Config
from .device import resolve_device
from .registry import Registry, build_from_cfg

__all__ = ['Config', 'Registry', 'build_from_cfg', 'resolve_device']
