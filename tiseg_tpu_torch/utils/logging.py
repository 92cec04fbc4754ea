"""The package's named logger and the JSONL structured log (port of
tiseg_tpu/utils/logging.py; reference tools/train.py:93 ``get_logger`` and
the mmcv ``.log.json`` records that tools/log_analysis.py reads)."""
from __future__ import annotations

import json
import logging
import os
import os.path as osp
import sys
from typing import Any, Dict, List, Optional


def get_logger(name: str = 'TisegTorch', log_file: Optional[str] = None, level: int = logging.INFO) -> logging.Logger:
    """The logger ``name``, given a stdout handler (and a file handler for
    ``log_file``) the first time it is asked for."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter('%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file is not None:
        os.makedirs(osp.dirname(osp.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class JsonlLogger:
    """Append-only structured log, one JSON object per line; tensors and
    numpy scalars are written through ``.item()``."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)

    def log(self, record: Dict[str, Any]):
        def _py(v):
            if hasattr(v, 'item'):
                try:
                    return v.item()
                except Exception:
                    return str(v)
            if isinstance(v, dict):
                return {k: _py(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [_py(x) for x in v]
            return v

        with open(self.path, 'a') as f:
            f.write(json.dumps({k: _py(v) for k, v in record.items()}) + '\n')

    def read(self) -> List[Dict[str, Any]]:
        if not osp.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
