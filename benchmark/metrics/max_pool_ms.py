"""max_pool_ms: the device time of the PointNet's global max-pool, forward
and backward, in ms a step of the traced epoch: the program's regions
`max_pool` and `max_pool_bwd` (one a PointNet call, nested in `encoder`
and `encoder_bwd`), between their marks (harness/program_trace.py), summed
over the epoch's steps.  None where the program launches no such marks.
Layer: train step."""

from benchmark.harness.program_trace import region_ms_a_step


def read(rec):
    return region_ms_a_step(rec, ('max_pool', 'max_pool_bwd'))
