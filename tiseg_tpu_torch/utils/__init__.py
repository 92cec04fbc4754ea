from .config import Config, parse_option_value
from .device import resolve_device
from .logging import JsonlLogger, get_logger
from .misc import Timer, ascii_table, get_bounding_box, set_random_seed
from .registry import Registry, build_from_cfg

__all__ = ['Config', 'JsonlLogger', 'Registry', 'Timer', 'ascii_table', 'build_from_cfg', 'get_bounding_box',
           'get_logger', 'parse_option_value', 'resolve_device', 'set_random_seed']
