"""masked_bn_ms: the device time of the masked batch norms, forward and
backward, in ms a step of the traced epoch: the program's regions
`masked_bn` and `masked_bn_bwd` (one a `MaskedBatchNorm` call), between
their marks (harness/program_trace.py), summed over the epoch's steps.
None where the program launches no marks.  Layer: train step."""

from benchmark.harness.program_trace import region_ms_a_step


def read(rec):
    return region_ms_a_step(rec, ('masked_bn', 'masked_bn_bwd'))
