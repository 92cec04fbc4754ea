"""Host-side (numpy) post-processing helpers (port of the part of
tiseg_tpu/models/utils/postprocess.py that the multi-task segmentors use)."""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def align_foreground(pred: np.ndarray, foreground: np.ndarray, time: int) -> np.ndarray:
    """Expand labelled ``pred`` into ``foreground`` for up to ``time - 1``
    8-neighbourhood waves: a grey dilation restricted to foreground pixels
    without a label, so a tie takes the larger label (the reference's BFS,
    tiseg/models/utils/postprocess.py:130-160, takes queue order)."""
    pred = pred.astype(np.int32).copy()
    fg = foreground > 0
    for _ in range(max(time - 1, 0)):
        grown = ndimage.grey_dilation(pred, footprint=np.ones((3, 3), bool))
        newly = (pred == 0) & fg & (grown > 0)
        if not newly.any():
            break
        pred[newly] = grown[newly]
    return pred
