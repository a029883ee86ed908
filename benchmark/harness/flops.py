"""Model FLOPs of one train step, from the config and the valid part counts
of the step's batch: the model's count is its reference family's
(reference/families/<model.name>.py), the chamfer's is counted here.

Only valid parts count, never padded slots.  A matmul of m x k by k x n is
2 m k n FLOPs forward; its backward is twice that (the input's gradient
and the weight's), less the input's gradient where the input is data (the
encoder's first layer).  The chamfer counts CHAMFER_FLOPS a point pair
(both directions from one distance, the pair once): the whole-shape pairs
and the part-to-same-part pairs, once for each MoN sample and supervised
iteration.  Nothing recomputed is counted, and neither is the semantic
matching's cost, which is no model work.
"""

from ..reference.families import family

CHAMFER_FLOPS = 8


def mm(m, k, n):
    return 2 * m * k * n


def label_dim(cfg):
    d = cfg['data']
    if d['dataset'] == 'geometry':
        return 0
    return int(d['max_num_part']) + (
        int(d['num_part_category']) if 'part_label' in d['data_keys'] else 0)


def model_flops(cfg, counts):
    """Forward plus backward FLOPs of the trained matmuls for a batch whose
    shapes have `counts` valid parts, by the config's model family."""
    return family(cfg).model_flops(cfg, counts)


def chamfer_calls(cfg):
    """Chamfers of one step: MoN samples x supervised iterations."""
    return int(cfg['loss'].get('sample_iter', 1)) * \
        int(family(cfg).iterations(cfg))


def chamfer_pairs(cfg, counts):
    """Point pairs of one step's chamfers (whole shape and part to part),
    summed over the MoN samples and supervised iterations."""
    N = int(cfg['data']['num_pc_points'])
    return chamfer_calls(cfg) * sum((n * N) ** 2 + n * N * N for n in counts)


def step_flops(cfg, counts):
    return model_flops(cfg, counts) + CHAMFER_FLOPS * chamfer_pairs(cfg,
                                                                    counts)
