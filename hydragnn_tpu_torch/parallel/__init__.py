"""Data, fully-sharded and edge-sharded parallelism over
``torch.distributed`` (the port's counterpart of
``hydragnn_tpu/parallel/``): the process helpers and meshes
(``mesh.py``), the ``Partitioner`` (``partitioner.py``), the
data-parallel steps with ZeRO-1 and FSDP layouts (``sharded.py``) and
the edge-sharded giant graphs (``edge_sharded.py``). One process drives
one card; ``setup_distributed`` makes the default group from the
launcher's environment (torchrun's, SLURM's or Open MPI's).
"""

from hydragnn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    barrier,
    get_comm_size_and_rank,
    globalize_batch,
    local_device_count,
    local_view,
    make_mesh,
    make_multihost_mesh,
    nsplit,
    setup_distributed,
)
from hydragnn_tpu_torch.parallel.edge_sharded import (
    make_dp_edge_eval_step,
    make_dp_edge_stats_step,
    make_dp_edge_train_step,
    place_dp_edge_batch,
    place_giant_batch,
)
from hydragnn_tpu_torch.parallel.partitioner import (
    AXIS_ORDER,
    EDGE_AXIS,
    FSDP_AXIS,
    ParallelConfig,
    Partitioner,
    parallel_manifest_summary,
)
from hydragnn_tpu_torch.parallel.sharded import (
    make_sharded_eval_step,
    make_sharded_stats_step,
    make_sharded_train_step,
    place_state,
)
