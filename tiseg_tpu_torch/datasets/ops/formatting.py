"""Batch formatting (port of tiseg_tpu/datasets/ops/formatting.py): split
the pipeline dict into {data, label, metas}. Images stay NHWC (channels
last) and float32, segmentation targets int32, regression targets float32;
the reference (tiseg/datasets/ops/formating.py:87-144) gives CHW."""
from __future__ import annotations

import numpy as np

REG_KEYS = ('dist_gt', 'point_gt', 'hv_gt', 'loss_weight_map', 'reg_dir_gt')


def format_img(img: np.ndarray) -> np.ndarray:
    if img.ndim < 3:
        img = img[..., None]
    return np.ascontiguousarray(img.astype(np.float32))


def format_seg(seg: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(seg.astype(np.int32))


def format_reg(reg: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(reg.astype(np.float32))


class Formatting:

    def __init__(self, data_keys, label_keys):
        self.data_keys = data_keys
        self.label_keys = label_keys

    def __call__(self, data, rng=None):
        ret = {'data': {}, 'label': {}, 'metas': {}}
        data_info = data.pop('data_info')
        data.pop('seg_fields', None)

        for key in self.data_keys:
            if key == 'img':
                h, w = data[key].shape[:2]
                data_info['input_hw'] = (h, w)
                ret['data'][key] = format_img(data[key])
            else:
                ret['data'][key] = np.asarray(data[key])

        for key in self.label_keys:
            if key in REG_KEYS:
                ret['label'][key] = format_reg(data[key])
            else:
                ret['label'][key] = format_seg(data[key])

        ret['metas'] = data_info
        return ret
