from .chamfer import (chamfer_diag, chamfer_diag_ref, chamfer_distance,
                      chamfer_distance_ref, chamfer_pairs, chamfer_parts,
                      chamfer_parts_ref, fused_mode, nn_distance,
                      set_fused_mode)
