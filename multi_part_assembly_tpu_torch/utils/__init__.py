from .config_utils import CN, CfgNode, cfg_to_dict, load_cfg_file, merge_cfg
from .eval_utils import (calc_connectivity_acc, calc_part_acc, rot_metrics,
                         trans_metrics)
from .loss import (_valid_mean, repulsion_cd_loss, rot_cosine_loss,
                   rot_l2_loss, rot_points_cd_loss, rot_points_l2_loss,
                   shape_cd_loss, trans_l2_loss)
from .rotation import (Rotation3D, matrix_to_quaternion, qeuler,
                       quaternion_apply, quaternion_invert,
                       quaternion_multiply, quaternion_to_matrix,
                       rot6d_to_matrix)
from .transforms import (qrot, random_quaternions, random_rotation_matrixs,
                         rmat_rot, rot_pc, transform_pc)
