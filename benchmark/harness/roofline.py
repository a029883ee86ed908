"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W)
and the least time of the chamfer kernels, as `chip_smoke.py` counts it.

A pair kernel serving both directions from one distance costs PAIR_OPS
operations a point pair, the pair counted once: three subtractions, three
products, two additions and one minimum for each direction.  Its bytes:
both clouds read, two distances and two witnesses written a point, and the
part counts.  The gradient kernel reads x, y (12 bytes each), the two
witnesses and the cotangents (4 each) of a valid point and writes its dx
(and dy); a padded point writes its zero dx (and dy).
"""

PEAK_OPS = 33.5e12        # f32 operations/s, outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
PAIR_OPS = 10


def bound_s(ops=0.0, nbytes=0.0):
    """(least seconds, 'operations' or 'bytes'): the larger of `ops` at
    PEAK_OPS and `nbytes` at PEAK_BYTES."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def pair_bound_s(pairs, B, P, N):
    """A B1/B3 launch over `pairs` point pairs of a [B, P, N] batch."""
    return bound_s(PAIR_OPS * pairs, B * P * N * (2 * 12 + 4 * 4) + 4 * B)


def grad_bound_s(valid_points, B, P, N, need_dy=False):
    """A B2/B4 launch: 64 bytes a valid point and 24 a padded one with dy,
    52 and 12 without."""
    point, padded = (64, 24) if need_dy else (52, 12)
    return bound_s(nbytes=point * valid_points +
                   padded * (B * P * N - valid_points))


def chamfer_step_bound_s(counts, P, N, calls):
    """Least seconds of one train step's chamfer launches: `calls` times
    (MoN samples x supervised iterations) the whole-shape chamfer (B1,
    then B2 without dy) and the per-part one (B3, then B4 without dy) of a
    batch whose shapes have `counts` valid parts."""
    B = len(counts)
    whole = sum((n * N) ** 2 for n in counts)
    diag = sum(n * N * N for n in counts)
    valid = sum(counts) * N
    one = (pair_bound_s(whole, B, P, N)[0] + pair_bound_s(diag, B, P, N)[0]
           + 2 * grad_bound_s(valid, B, P, N)[0])
    return calls * one
