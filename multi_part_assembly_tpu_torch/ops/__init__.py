from .chamfer import (LAUNCHES, chamfer_diag, chamfer_diag_ref,
                      chamfer_distance, chamfer_distance_ref, chamfer_pairs,
                      chamfer_parts, chamfer_parts_ref, fused_mode,
                      nn_distance, reset_launches, set_fused_mode)
