"""pair_mlp_ms: the device time of the graph families' pair MLPs, forward
and backward, in ms a step of the traced epoch: the program's regions
`edge_mlp` (the pair concat, the edge MLP over all P x P pairs with its
batch norms, the relation-weighted mean) and `relation` (the pose encoder
and the RelationNet over the pose pairs), with their `_bwd`, between their
marks (harness/program_trace.py).  None where the program launches no
such marks.  Layer: train step."""

from benchmark.harness.program_trace import region_ms_a_step


def read(rec):
    return region_ms_a_step(rec, ('edge_mlp', 'edge_mlp_bwd', 'relation',
                                  'relation_bwd'))
