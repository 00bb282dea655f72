"""Parallelism over processes, one device each (`pcfa_tpu/parallel/`):

* `multihost`: joining the process group (`initialize`), each process's
  dataset slice (`process_shard`), the global batch's convention;
* `mesh`: the 'data' and 'space' groups and their collectives;
* `dp`: per-pair attacks split over the ranks (`pcfa_attack_dp`) and the
  universal δ trained on a batch split over them
  (`universal_batch_attack_dp`);
* `sp`: RAFT's and GMA's correlation volume and attention split by rows
  (`spatial_flow_fn`).
"""

from pcfa_tpu_torch.parallel.mesh import data_mesh
from pcfa_tpu_torch.parallel.dp import (
    make_pcfa_attack_dp,
    pcfa_attack_dp,
    universal_batch_attack_dp,
)
from pcfa_tpu_torch.parallel.sp import space_mesh, spatial_flow_fn
