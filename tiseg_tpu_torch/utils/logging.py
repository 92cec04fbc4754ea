"""The package's named logger (port of ``get_logger`` of
tiseg_tpu/utils/logging.py; reference tools/train.py:93)."""
from __future__ import annotations

import logging
import os
import os.path as osp
import sys
from typing import Optional


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
