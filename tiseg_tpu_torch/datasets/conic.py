"""CoNIC 7-class dataset with class-wise AJI/PQ via majority-vote instance
classing (port of tiseg_tpu/datasets/conic.py; reference
tiseg/datasets/conic.py:21-323)."""
from __future__ import annotations

from ..utils import get_logger
from ..utils.metrics import (pre_eval_aji, pre_eval_all_semantic_metric, pre_eval_bin_aji, pre_eval_bin_pq,
                             pre_eval_pq, pre_eval_to_aji, pre_eval_to_bin_aji, pre_eval_to_bin_pq,
                             pre_eval_to_imw_aji, pre_eval_to_imw_pq, pre_eval_to_imw_sem_metrics, pre_eval_to_pq,
                             pre_eval_to_sem_metrics)
from .builder import DATASETS
from .custom import SHOW_FOLDER, CustomDataset
from .utils.instance import assign_sem_class_to_insts, re_instance


@DATASETS.register_module()
class CoNICDataset(CustomDataset):

    CLASSES = ('background', 'neutrophil', 'epithelial', 'lymphocyte', 'plasma', 'eosinophil', 'connective')
    PALETTE = [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0], [255, 0, 255], [0, 255, 255]]

    def __init__(self, **kwargs):
        kwargs.setdefault('img_suffix', '.png')
        super().__init__(**kwargs)

    def pre_eval(self, preds, indices, show=False, show_folder=None):
        if not isinstance(indices, list):
            indices = [indices]
        if not isinstance(preds, list):
            preds = [preds]

        results = []
        for pred, index in zip(preds, indices):
            sem_gt, inst_gt = self._load_gts(index)
            sem_pred = pred['sem_pred'].copy()
            inst_pred = re_instance(pred['inst_pred'])

            n_cls = len(self.CLASSES)
            pred_per_class = assign_sem_class_to_insts(inst_pred, sem_pred, n_cls)
            gt_per_class = assign_sem_class_to_insts(inst_gt, sem_gt, n_cls)

            results.append(
                dict(sem_pre_eval_res=pre_eval_all_semantic_metric(sem_pred, sem_gt, n_cls),
                     aji_pre_eval_res=pre_eval_aji(inst_pred, inst_gt, pred_per_class, gt_per_class, n_cls),
                     bin_aji_pre_eval_res=pre_eval_bin_aji(inst_pred, inst_gt),
                     pq_pre_eval_res=pre_eval_pq(inst_pred, inst_gt, pred_per_class, gt_per_class, n_cls),
                     bin_pq_pre_eval_res=pre_eval_bin_pq(inst_pred, inst_gt)))
            if show:
                self._show(pred, index, show_folder or SHOW_FOLDER)
        return results

    def evaluate(self, results, logger=None, **kwargs):
        ret, imw = {}, {}
        cols = {}
        for r in results:
            for k, v in r.items():
                cols.setdefault(k, []).append(v)

        sem_pre = cols.pop('sem_pre_eval_res')
        ret.update(pre_eval_to_sem_metrics(sem_pre, metrics=['Dice', 'Precision', 'Recall']))
        imw.update(pre_eval_to_imw_sem_metrics(sem_pre, metrics=['Dice', 'Precision', 'Recall']))

        aji_pre = cols.pop('aji_pre_eval_res')
        bin_aji_pre = cols.pop('bin_aji_pre_eval_res')
        ret.update(pre_eval_to_aji(aji_pre))
        for k, v in pre_eval_to_bin_aji(bin_aji_pre).items():
            ret['b' + k] = v
        imw.update(pre_eval_to_imw_aji(bin_aji_pre))

        pq_pre = cols.pop('pq_pre_eval_res')
        bin_pq_pre = cols.pop('bin_pq_pre_eval_res')
        ret.update(pre_eval_to_pq(pq_pre))
        for k, v in pre_eval_to_bin_pq(bin_pq_pre).items():
            ret['b' + k] = v
        imw.update(pre_eval_to_imw_pq(bin_pq_pre))

        names = [info['data_id'] for info in self.data_infos[:len(results)]]
        return self._tabulate(ret, imw, names, get_logger())

    VITAL_KEYS = ('Dice', 'Precision', 'Recall', 'Aji', 'DQ', 'SQ', 'PQ')
