"""DatasetMapper: file reading and pipeline driving (port of
tiseg_tpu/datasets/mapper.py; reference tiseg/datasets/dataset_mapper.py:11-58)."""
from __future__ import annotations

import copy
import os.path as osp
from typing import Optional

import numpy as np

from .ops import Rng, class_dict


def read_image(path: str) -> np.ndarray:
    """tif as 3-channel RGB (what the reference's cv2.imread + BGR->RGB
    gives), npy via numpy, everything else via PIL as stored: a palette
    label PNG gives its class ids, a single-channel BMP an (H, W) array."""
    suffix = osp.splitext(path)[1]
    if suffix == '.npy':
        return np.load(path)
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.convert('RGB') if suffix == '.tif' else im)


class DatasetMapper:
    """Seed the pipeline dict from one data_info and run the processes
    list (names resolved via :data:`tiseg_tpu_torch.datasets.ops.class_dict`),
    each with the sample's random streams."""

    def __init__(self, test_mode: bool, *, processes):
        self.test_mode = test_mode
        self.processes = []
        for process in processes:
            process = dict(process)
            cls_name = process.pop('type')
            self.processes.append(class_dict[cls_name](**process))

    def __call__(self, data_info, seed: Optional[int] = None):
        """One sample; ``seed`` seeds its :class:`~.ops.Rng` (the same
        integer as ``random.seed``/``np.random.seed`` before the JAX
        mapper gives the same sample)."""
        data_info = copy.deepcopy(dict(data_info))
        img = read_image(data_info['file_name'])
        sem_gt = read_image(data_info['sem_file_name'])
        inst_gt = read_image(data_info['inst_file_name'])
        data_info['ori_hw'] = img.shape[:2]
        if img.shape[:2] != sem_gt.shape[:2]:
            raise ValueError(f"{data_info['file_name']}: image {img.shape[:2]} and semantic map "
                             f'{sem_gt.shape[:2]} differ in size')
        data = {
            'img': img,
            'sem_gt': sem_gt,
            'inst_gt': inst_gt,
            'seg_fields': ['sem_gt', 'inst_gt'],
            'data_info': data_info,
        }
        rng = Rng.seeded(seed)
        for process in self.processes:
            data = process(data, rng)
        return data
