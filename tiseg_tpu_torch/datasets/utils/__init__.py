from .center import calculate_centerpoint, fast_centerpoint
from .direction import (LABEL_TO_VECTOR, align_angle, angle_to_direction_label, angle_to_vector,
                        generate_direction_differential_map, get_dir_from_inst, label_to_vector, vector_to_label)
from .gradient import calculate_gradient, sobel_kernels
from .instance import (assign_sem_class_to_insts, convert_instance_to_semantic, fix_instance, get_tc_from_inst,
                       re_instance, to_one_hot)

__all__ = ['calculate_centerpoint', 'fast_centerpoint', 'calculate_gradient', 'sobel_kernels', 'LABEL_TO_VECTOR',
           'align_angle', 'angle_to_vector', 'angle_to_direction_label', 'vector_to_label', 'label_to_vector',
           'generate_direction_differential_map', 'get_dir_from_inst', 're_instance', 'fix_instance',
           'convert_instance_to_semantic', 'get_tc_from_inst', 'to_one_hot', 'assign_sem_class_to_insts']
