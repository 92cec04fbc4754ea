"""Python-file config system with ``_base_`` inheritance and dotted overrides.

A copy of ``tiseg_tpu/utils/config.py`` (the port imports nothing of the JAX
package), so the repository's config files load unchanged. Rebuilds the capability of mmcv's ``Config.fromfile`` used throughout the
reference (reference: tools/train.py:57, configs/unet/*.py:1-4) without mmcv:

- configs are plain ``.py`` files; every non-underscore top-level variable is
  part of the config;
- ``_base_ = ['../_base_/default_runtime.py', ...]`` merges parent configs
  (recursive dict merge, later entries win, the file itself wins last);
- a dict value containing ``_delete_: True`` replaces instead of merges;
- ``merge_from_options({'model.train_cfg.foo': 1})`` implements the CLI
  ``--options`` dotted-key overrides (reference: tools/train.py:42);
- ``cfg.dump(path)`` writes a self-contained python config.
"""
from __future__ import annotations

import ast
import copy
import os
import os.path as osp
import pprint
import types
from typing import Any, Dict, List, Union

DELETE_KEY = '_delete_'
BASE_KEY = '_base_'


class CfgDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = wrap_cfg(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, wrap_cfg(value))

    def __deepcopy__(self, memo):
        other = CfgDict()
        for k, v in self.items():
            dict.__setitem__(other, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return other

    def get(self, key, default=None):
        return super().get(key, default)

    def copy(self):
        return copy.deepcopy(self)


def wrap_cfg(value: Any) -> Any:
    if isinstance(value, dict) and not isinstance(value, CfgDict):
        return CfgDict({k: wrap_cfg(v) for k, v in value.items()})
    if isinstance(value, CfgDict):
        return value
    if isinstance(value, (list, tuple)):
        return type(value)(wrap_cfg(v) for v in value)
    return value


def _validate_py_syntax(filename: str):
    with open(filename) as f:
        content = f.read()
    try:
        ast.parse(content)
    except SyntaxError as e:
        raise SyntaxError(f'Config file {filename} has syntax error: {e}')


def _load_py_file(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f'Config file not found: {filename}')
    _validate_py_syntax(filename)
    mod = types.ModuleType('_cfg_')
    mod.__file__ = filename
    with open(filename) as f:
        code = compile(f.read(), filename, 'exec')
    exec(code, mod.__dict__)
    cfg = {
        k: v
        for k, v in mod.__dict__.items()
        if not k.startswith('__') and not isinstance(v, (types.ModuleType, types.FunctionType, type))
    }
    return cfg


def merge_dict(base: Dict, override: Dict) -> Dict:
    """Recursively merge ``override`` into ``base`` (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and v.get(DELETE_KEY, False):
            v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            out[k] = v
        elif k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dict(out[k], v)
        else:
            out[k] = v
    return out


class Config:
    """Config object backed by a CfgDict."""

    def __init__(self, cfg_dict: Dict[str, Any] = None, filename: str = None):
        self._cfg_dict = wrap_cfg(cfg_dict or {})
        self._filename = filename

    # -- construction ------------------------------------------------------
    @staticmethod
    def fromfile(filename: str) -> 'Config':
        cfg_dict = Config._file_to_dict(filename)
        return Config(cfg_dict, filename=filename)

    @staticmethod
    def _file_to_dict(filename: str) -> Dict[str, Any]:
        filename = osp.abspath(osp.expanduser(filename))
        cfg = _load_py_file(filename)
        base_files = cfg.pop(BASE_KEY, [])
        if isinstance(base_files, str):
            base_files = [base_files]
        merged: Dict[str, Any] = {}
        for base in base_files:
            base_path = osp.join(osp.dirname(filename), base)
            merged = merge_dict(merged, Config._file_to_dict(base_path))
        merged = merge_dict(merged, cfg)
        return merged

    @staticmethod
    def fromdict(cfg_dict: Dict[str, Any]) -> 'Config':
        return Config(cfg_dict)

    # -- access ------------------------------------------------------------
    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        try:
            return self._cfg_dict[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith('_'):
            super().__setattr__(name, value)
        else:
            self._cfg_dict[name] = value

    def __getitem__(self, key):
        return self._cfg_dict[key]

    def __setitem__(self, key, value):
        self._cfg_dict[key] = value

    def __contains__(self, key):
        return key in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def __repr__(self):
        return f'Config (file: {self._filename}):\n{self.pretty_text}'

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def to_dict(self) -> Dict[str, Any]:
        def _plain(v):
            if isinstance(v, dict):
                return {k: _plain(vv) for k, vv in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(_plain(vv) for vv in v)
            return v

        return _plain(dict(self._cfg_dict))

    def copy(self) -> 'Config':
        return Config(copy.deepcopy(self._cfg_dict), filename=self._filename)

    # -- mutation ----------------------------------------------------------
    def merge_from_options(self, options: Dict[str, Any]):
        """Apply dotted-key overrides, e.g. {'model.num_classes': 3}."""
        for full_key, value in options.items():
            d = self._cfg_dict
            keys = full_key.split('.')
            for k in keys[:-1]:
                if k not in d or not isinstance(d[k], dict):
                    d[k] = CfgDict()
                d = d[k]
            d[keys[-1]] = value

    # -- serialization -----------------------------------------------------
    @property
    def pretty_text(self) -> str:
        parts = []
        for k, v in self._cfg_dict.items():
            parts.append(f'{k} = {pprint.pformat(self._plain(v), width=100)}')
        return '\n'.join(parts)

    @staticmethod
    def _plain(v):
        if isinstance(v, dict):
            return {k: Config._plain(vv) for k, vv in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(Config._plain(vv) for vv in v)
        return v

    def dump(self, path: str):
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            f.write(self.pretty_text + '\n')


def parse_option_value(value: str) -> Any:
    """Parse a CLI --options value string into a python value."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lowered = value.lower()
        if lowered in ('true', 'false'):
            return lowered == 'true'
        if lowered in ('none', 'null'):
            return None
        if ',' in value:
            return [parse_option_value(v) for v in value.split(',') if v]
        return value
