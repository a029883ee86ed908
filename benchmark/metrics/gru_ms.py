"""gru_ms: the device time of the graph families' GRUs, forward and
backward, in ms a step of the traced epoch: the program's regions `gru`
and `gru_bwd` (one a `MaskedGRU` call of RGL-Net's node update, a round),
between their marks (harness/program_trace.py), summed over the epoch's
steps.  None where the program launches no such marks.  Layer: train
step."""

from benchmark.harness.program_trace import region_ms_a_step


def read(rec):
    return region_ms_a_step(rec, ('gru', 'gru_bwd'))
