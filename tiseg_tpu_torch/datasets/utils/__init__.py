from .direction import LABEL_TO_VECTOR
from .instance import (assign_sem_class_to_insts, convert_instance_to_semantic, fix_instance, get_tc_from_inst,
                       re_instance, to_one_hot)

__all__ = ['LABEL_TO_VECTOR', 're_instance', 'fix_instance', 'convert_instance_to_semantic', 'get_tc_from_inst',
           'to_one_hot', 'assign_sem_class_to_insts']
