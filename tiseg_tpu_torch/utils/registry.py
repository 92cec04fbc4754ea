"""Minimal registry for config-driven polymorphism.

A copy of ``tiseg_tpu/utils/registry.py``: the port imports nothing of the
JAX package. It rebuilds the registry pattern the reference inherits from
mmcv (reference: tiseg/models/builder.py:6-12). Pure Python.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class/callable mapping with config-dict instantiation."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    def __len__(self):
        return len(self._module_dict)

    def __contains__(self, key):
        return key in self._module_dict

    def __repr__(self):
        return f'Registry(name={self._name}, items={list(self._module_dict)})'

    @property
    def name(self):
        return self._name

    @property
    def module_dict(self):
        return self._module_dict

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None, module: Optional[Any] = None, force: bool = False):
        """Register a module class. Usable as decorator (with or without args)
        or as a plain call with ``module=``."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool):
        if not callable(module):
            raise TypeError(f'module must be callable, got {type(module)}')
        key = name or module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f'{key} is already registered in {self._name}')
        self._module_dict[key] = module

    def build(self, cfg: Dict[str, Any], default_args: Optional[Dict[str, Any]] = None) -> Any:
        """Instantiate from a config dict with a ``type`` key."""
        return build_from_cfg(cfg, self, default_args)


def build_from_cfg(cfg: Dict[str, Any], registry: Registry, default_args: Optional[Dict[str, Any]] = None) -> Any:
    if not isinstance(cfg, dict) or 'type' not in cfg:
        raise TypeError(f'cfg must be a dict with a "type" key, got {cfg!r}')
    args = dict(cfg)
    obj_type = args.pop('type')
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not in the {registry.name} registry. '
                           f'Available: {sorted(registry.module_dict)}')
    elif inspect.isclass(obj_type) or callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f'type must be a str or callable, got {type(obj_type)}')
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)
