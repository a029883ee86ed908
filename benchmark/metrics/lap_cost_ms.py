"""lap_cost_ms: the device time of the semantic matching's LAP cost, in
ms a step of the traced epoch: the program's region `lap_cost` (inside
`matching`: the subsampled clouds moved by the predicted and the true
poses, their pair chamfer cost and its block mask), between its marks
(harness/program_trace.py).  The solve (kernel L1) and the gathers of the
matching are outside it.  None where the program launches no marks, or
matches nothing (geometric data).  Layer: train step."""

from benchmark.harness.program_trace import region_ms_a_step


def read(rec):
    return region_ms_a_step(rec, ('lap_cost', ))
