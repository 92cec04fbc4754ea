"""CustomDataset: binary nuclei segmentation dataset with AJI/PQ/semantic
evaluation (port of tiseg_tpu/datasets/custom.py; reference
tiseg/datasets/custom.py:107-435).

File contract: ``<id><img_suffix>`` (.tif), ``<id>_sem.png``,
``<id>_inst.npy``; listing either from a split txt or a directory scan.
"""
from __future__ import annotations

import os
import os.path as osp
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..utils import ascii_table, get_logger
from ..utils.metrics import (pre_eval_all_semantic_metric, pre_eval_bin_aji, pre_eval_bin_pq, pre_eval_to_aji,
                             pre_eval_to_bin_aji, pre_eval_to_bin_pq, pre_eval_to_imw_aji, pre_eval_to_imw_pq,
                             pre_eval_to_imw_inst_dice, pre_eval_to_imw_sem_metrics, pre_eval_to_inst_dice,
                             pre_eval_to_pq, pre_eval_to_sem_metrics)
from .builder import DATASETS
from .mapper import DatasetMapper, read_image
from .utils.instance import re_instance

SHOW_FOLDER = '.nuclei_show'  # where show=True draws when no folder is given


def scandir(root: str, suffix: str):
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(suffix):
                yield osp.relpath(osp.join(dirpath, f), root)


@DATASETS.register_module()
class CustomDataset:

    CLASSES = ('background', 'nuclei')
    PALETTE = [[0, 0, 0], [255, 2, 255]]

    def __init__(self, processes, img_dir, ann_dir, data_root=None, img_suffix='.tif', sem_suffix='_sem.png',
                 inst_suffix='_inst.npy', test_mode=False, split=None):
        self.mapper = DatasetMapper(test_mode, processes=processes)
        self.img_dir = img_dir
        self.ann_dir = ann_dir
        self.data_root = data_root
        self.img_suffix = img_suffix
        self.sem_suffix = sem_suffix
        self.inst_suffix = inst_suffix
        self.test_mode = test_mode
        self.split = split

        if self.data_root is not None:
            if not osp.isabs(self.img_dir):
                self.img_dir = osp.join(self.data_root, self.img_dir)
            if not (self.ann_dir is None or osp.isabs(self.ann_dir)):
                self.ann_dir = osp.join(self.data_root, self.ann_dir)
            if not (self.split is None or osp.isabs(self.split)):
                self.split = osp.join(self.data_root, self.split)

        self.data_infos = self.load_annotations(self.img_dir, self.ann_dir, self.img_suffix, self.sem_suffix,
                                                self.inst_suffix, self.split)

    def __len__(self):
        return len(self.data_infos)

    def __getitem__(self, index):
        return self.sample(index)

    def sample(self, index, seed: Optional[int] = None):
        """Sample ``index`` through the pipeline, its random streams seeded
        with ``seed`` (the loader's :func:`~.builder.sample_seed`)."""
        return self.mapper(self.data_infos[index], seed)

    def load_annotations(self, img_dir, ann_dir, img_suffix, sem_suffix, inst_suffix, split=None) -> List[Dict]:
        data_infos = []
        if split is not None:
            with open(split) as fp:
                ids = [line.strip() for line in fp if line.strip()]
            names = [i + img_suffix for i in ids]
        else:
            names = list(scandir(img_dir, img_suffix))
        for img_name in names:
            data_infos.append(
                dict(data_id=osp.splitext(img_name)[0],
                     file_name=osp.join(img_dir, img_name),
                     sem_file_name=osp.join(ann_dir, img_name.replace(img_suffix, sem_suffix)),
                     inst_file_name=osp.join(ann_dir, img_name.replace(img_suffix, inst_suffix))))
        return data_infos

    # ------------------------------------------------------------------ eval
    def _load_gts(self, index):
        sem_gt = read_image(self.data_infos[index]['sem_file_name'])
        inst_gt = re_instance(read_image(self.data_infos[index]['inst_file_name']))
        return sem_gt, inst_gt

    def _data_id(self, index):
        return osp.basename(self.data_infos[index]['sem_file_name']).replace(self.sem_suffix, '')

    def pre_eval(self, preds, indices, show=False, show_folder=None):
        """Per-image metric pre-eval packages for {'sem_pred', 'inst_pred'}
        results (reference custom.py:219-305); ``show`` also draws each
        image's panels into ``show_folder``."""
        if not isinstance(indices, list):
            indices = [indices]
        if not isinstance(preds, list):
            preds = [preds]

        results = []
        for pred, index in zip(preds, indices):
            sem_gt, inst_gt = self._load_gts(index)
            inst_pred = re_instance(pred['inst_pred'])
            results.append(
                dict(name=self._data_id(index),
                     sem_pre_eval_res=pre_eval_all_semantic_metric(pred['sem_pred'], sem_gt, len(self.CLASSES)),
                     bin_aji_pre_eval_res=pre_eval_bin_aji(inst_pred, inst_gt),
                     bin_pq_pre_eval_res=pre_eval_bin_pq(inst_pred, inst_gt)))
            if show:
                self._show(pred, index, show_folder or SHOW_FOLDER)
        return results

    def _show(self, pred, index, show_folder):
        """The image's comparison panel, and its direction panel where the
        prediction holds ``dir_pred`` (``utils/draw.py``)."""
        from .utils.draw import draw_all, draw_direction
        os.makedirs(show_folder, exist_ok=True)
        sem_gt, inst_gt = self._load_gts(index)
        info = self.data_infos[index]
        name = info['data_id'].replace('/', '_')
        draw_all(show_folder, name, info['file_name'], pred['sem_pred'], sem_gt, re_instance(pred['inst_pred']),
                 re_instance(inst_gt), pred.get('tc_sem_pred', pred['sem_pred']), None)
        if 'dir_pred' in pred:
            draw_direction(show_folder, name, info['file_name'], pred, sem_gt, inst_gt,
                           num_angles=int(pred.get('dir_num_angles', 8)))

    def pre_eval_device(self, preds, indices, max_instances: int = 1024, device=None):
        """On-device pre-eval on ``device`` (``cuda`` when None): relabel,
        semantic confusion and binary AJI/PQ of each image
        (``ops/inst_metrics.py``); only the pre-eval numbers reach the host,
        in one copy per image. The package layout matches :meth:`pre_eval`,
        so :meth:`evaluate` reduces both identically.

        Restrictions against the host path (both guarded, never silent):
        - the device contingency table is (max_instances+1)^2: an image with
          more instances in pred or gt takes the host pre_eval, with a
          warning (a dense 1000^2 MoNuSeg tile can approach 1024);
        - the device PQ has no Hungarian branch: exact only for the default
          match_iou >= 0.5, where matches are unique."""
        import torch

        from ..ops.inst_metrics import pre_eval_all_device
        from ..utils.device import resolve_device
        device = resolve_device(device)
        if not isinstance(indices, list):
            indices = [indices]
        if not isinstance(preds, list):
            preds = [preds]
        results = []
        for pred, index in zip(preds, indices):
            sem_gt, inst_gt = self._load_gts(index)
            # count positive ids only: `len(unique) - 1` would undercount by
            # one on a plane without background
            n_pred = int((np.unique(np.asarray(pred['inst_pred'])) > 0).sum())
            n_gt = int((np.unique(inst_gt) > 0).sum())
            if max(n_pred, n_gt) > max_instances:
                get_logger().warning('image %s has %d instances > device cap %d; using host pre_eval',
                                     index, max(n_pred, n_gt), max_instances)
                results.extend(self.pre_eval([pred], [index]))
                continue

            def to_device(a):
                return torch.from_numpy(np.ascontiguousarray(np.asarray(a), dtype=np.int32)).to(device)

            sem, aji, pq = pre_eval_all_device(to_device(pred['sem_pred']), to_device(pred['inst_pred']),
                                               to_device(sem_gt), to_device(inst_gt),
                                               num_classes=len(self.CLASSES), max_instances=max_instances)
            n = len(self.CLASSES)
            flat = torch.cat([torch.stack(sem).reshape(-1), torch.stack(aji), torch.stack(pq)]).cpu().numpy()
            # the host package stores the reduce_zero_label'd histograms
            # (classes 1..C-1, sem_metrics.py pre_eval_all_semantic_metric)
            results.append(
                dict(name=self._data_id(index),
                     sem_pre_eval_res=tuple(flat[i * n + 1:(i + 1) * n] for i in range(len(sem))),
                     bin_aji_pre_eval_res=tuple(float(x) for x in flat[6 * n:6 * n + 2]),
                     bin_pq_pre_eval_res=tuple(float(x) for x in flat[6 * n + 2:])))
        return results

    def evaluate(self, results, logger=None, **kwargs):
        """Merge per-image pre-eval packages into the m*/imw*/b* tables
        (reference custom.py:307-435)."""
        log = get_logger()
        ret, imw = {}, {}
        cols: Dict[str, list] = {}
        for r in results:
            for k, v in r.items():
                cols.setdefault(k, []).append(v)

        names = cols.pop('name')
        sem_pre = cols.pop('sem_pre_eval_res')
        ret.update(pre_eval_to_sem_metrics(sem_pre, metrics=['Dice', 'Precision', 'Recall']))
        imw.update(pre_eval_to_imw_sem_metrics(sem_pre, metrics=['Dice', 'Precision', 'Recall']))

        aji_pre = cols.pop('bin_aji_pre_eval_res')
        ret.update(pre_eval_to_aji(aji_pre))
        for k, v in pre_eval_to_bin_aji(aji_pre).items():
            ret['b' + k] = v
        imw.update(pre_eval_to_imw_aji(aji_pre))

        pq_pre = cols.pop('bin_pq_pre_eval_res')
        ret.update(pre_eval_to_pq(pq_pre))
        for k, v in pre_eval_to_bin_pq(pq_pre).items():
            ret['b' + k] = v
        ret.update(pre_eval_to_inst_dice(pq_pre))
        imw.update(pre_eval_to_imw_pq(pq_pre))
        imw.update(pre_eval_to_imw_inst_dice(pq_pre))

        return self._tabulate(ret, imw, names, log)

    VITAL_KEYS = ('Dice', 'Precision', 'Recall', 'Aji', 'DQ', 'SQ', 'PQ', 'InstDice')
    OVERALL_EXTRA = ('bAji', 'bDQ', 'bSQ', 'bPQ')

    def _tabulate(self, ret, imw, names, log):
        names = list(names) + ['Average']
        for key in imw:
            vals = np.asarray(imw[key], dtype=np.float64)
            if vals.ndim == 2:
                vals = vals[:, 0]
            imw[key] = np.concatenate([vals, [np.nanmean(vals)]])

        mean_metrics = OrderedDict()
        overall_metrics = OrderedDict()
        for key in self.VITAL_KEYS:
            if key in imw:
                mean_metrics['imw' + key] = imw[key][-1]
            if key in ret:
                overall_metrics['m' + key] = ret[key]
        for key in self.OVERALL_EXTRA:
            if key in ret:
                overall_metrics[key] = ret[key]

        sample_rows = [[n] + [np.round(imw[k][i] * 100, 2) for k in imw] for i, n in enumerate(names)]
        log.info('Per samples:\n' + ascii_table(['name'] + list(imw.keys()), sample_rows))

        # nanmean: a class absent from both pred & gt contributes no signal
        mean_metrics = OrderedDict({k: np.round(np.nanmean(v) * 100, 2) for k, v in mean_metrics.items()})
        overall_metrics = OrderedDict({k: np.round(np.nanmean(v) * 100, 2) for k, v in overall_metrics.items()})
        log.info('Mean Total:\n' + ascii_table(list(mean_metrics), [list(mean_metrics.values())]))
        log.info('Overall Total:\n' + ascii_table(list(overall_metrics), [list(overall_metrics.values())]))

        storage_results = {'mean_metrics': mean_metrics, 'overall_metrics': overall_metrics}
        eval_results = {}
        eval_results.update(mean_metrics)
        eval_results.update(overall_metrics)
        return eval_results, storage_results


@DATASETS.register_module()
class MoNuSegDataset(CustomDataset):
    """MoNuSeg (kumar) nuclei dataset (reference monuseg.py:6-18)."""

    def __init__(self, **kwargs):
        super().__init__(img_suffix='.tif', sem_suffix='_sem.png', inst_suffix='_inst.npy', **kwargs)


@DATASETS.register_module()
class MoNuSegDatasetDebug(MoNuSegDataset):
    """Debug twin of MoNuSegDataset used by the reference's label-radius
    ablation configs (reference monuseg_debug.py:19-241): same contract."""


@DATASETS.register_module()
class CPM17Dataset(CustomDataset):
    """CPM17 nuclei dataset (reference cpm17.py:6-14)."""

    def __init__(self, **kwargs):
        super().__init__(img_suffix='.png', sem_suffix='_sem.png', inst_suffix='_inst.npy', **kwargs)


@DATASETS.register_module()
class CoNSePDataset(CustomDataset):
    """CoNSeP nuclei dataset (reference consep.py:6-14)."""

    def __init__(self, **kwargs):
        super().__init__(img_suffix='.png', sem_suffix='_sem.png', inst_suffix='_inst.npy', **kwargs)


@DATASETS.register_module()
class GlasDataset(CustomDataset):
    """GlaS gland dataset (reference glas.py:6-14)."""

    CLASSES = ('background', 'gland')

    def __init__(self, **kwargs):
        super().__init__(img_suffix='.png', sem_suffix='_sem.png', inst_suffix='_inst.npy', **kwargs)


@DATASETS.register_module()
class OSCDDataset(CustomDataset):
    """OSCD carton segmentation dataset (reference oscd.py:18-200).

    Unlike the nuclei datasets, OSCD's pre_eval applies its own model-
    agnostic post-processing to the semantic prediction and returns direct
    per-image scalar metrics (Aji/Dice/Recall/Precision), which evaluate()
    averages."""

    CLASSES = ('background', 'carton')
    PALETTE = [[0, 0, 0], [255, 2, 255]]

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.png')
        super().__init__(**kwargs)

    def _model_agnostic_postprocess(self, fore_pred):
        from ..utils import morphology as m
        mask = m.binary_fill_holes(fore_pred > 0)
        mask = m.remove_small_objects(mask, 64)
        inst_pred = m.label(mask)
        sem_pred = (inst_pred > 0).astype(np.uint8)
        return sem_pred, inst_pred

    def pre_eval(self, preds, indices, show=False, show_folder=None):
        from ..utils.metrics import binary_aggregated_jaccard_index, dice_similarity_coefficient, precision_recall
        if not isinstance(indices, list):
            indices = [indices]
        if not isinstance(preds, list):
            preds = [preds]

        results = []
        for pred, index in zip(preds, indices):
            sem_gt, inst_gt = self._load_gts(index)
            _, inst_pred = self._model_agnostic_postprocess((pred['sem_pred'] == 1).astype(np.uint8))
            sem_pred = (inst_pred > 0).astype(np.uint8)

            precision, recall = precision_recall(sem_pred, sem_gt, 2)
            dice = dice_similarity_coefficient(sem_pred, sem_gt, 2)[1]
            aji = binary_aggregated_jaccard_index(re_instance(inst_pred), inst_gt)
            results.append(dict(Aji=aji, Dice=dice, Recall=recall[1], Precision=precision[1]))
            if show:
                self._show(pred, index, show_folder or SHOW_FOLDER)
        return results

    def evaluate(self, results, logger=None, **kwargs):
        keys = ('Aji', 'Dice', 'Recall', 'Precision')
        eval_results = OrderedDict({k: np.round(np.nanmean([r[k] for r in results]) * 100, 2) for k in keys})
        get_logger().info('OSCD eval:\n' + ascii_table(list(eval_results), [list(eval_results.values())]))
        storage = {'mean_metrics': eval_results, 'overall_metrics': eval_results}
        return eval_results, storage
