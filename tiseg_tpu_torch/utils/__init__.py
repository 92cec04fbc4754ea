from .config import Config
from .device import resolve_device
from .logging import get_logger
from .misc import ascii_table
from .registry import Registry, build_from_cfg

__all__ = ['Config', 'Registry', 'ascii_table', 'build_from_cfg', 'get_logger', 'resolve_device']
