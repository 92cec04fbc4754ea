from .sem_metrics import (pre_eval_all_semantic_metric, pre_eval_to_sem_metrics, pre_eval_to_imw_sem_metrics,
                          total_area_to_sem_metrics, accuracy, precision_recall, dice_similarity_coefficient,
                          intersect_and_union)
from .inst_metrics import (pre_eval_bin_aji, pre_eval_aji, pre_eval_bin_pq, pre_eval_pq, binary_aggregated_jaccard_index,
                           aggregated_jaccard_index, binary_panoptic_quality, panoptic_quality, binary_inst_dice,
                           pre_eval_to_bin_aji, pre_eval_to_aji, pre_eval_to_imw_aji, pre_eval_to_bin_pq,
                           pre_eval_to_pq, pre_eval_to_imw_pq, pre_eval_to_inst_dice, pre_eval_to_imw_inst_dice)

__all__ = [k for k in dir() if not k.startswith('_')]
