"""Mesh and collectives scaling layer on torch.distributed: the port of
qnnpack_tpu/parallel, one process a device (NCCL on the card, gloo on the
CPU).

  DP  mesh.py      batch sharding over the "data" axis
  TP  mesh.py      (a) output-channel weight sharding (ColumnShard, an
                   all-gather of channels a layer); (b) K-dim /
                   input-channel sharding with an int32 all-reduce of the
                   partial instances' sums before the q8requant epilogue
                   (gemm_kdim_tp, conv_ic_tp)
  SP  halo.py      spatial H sharding with a point-to-point halo exchange
  PP  pipeline.py  stage-partitioned microbatch pipeline over
                   point-to-point sends
  EP  expert.py    grouped-conv group sharding (collective-free)
  MH  multihost.py world lifecycle, host x device hybrid meshes, per-host
                   input feeding, slice-restart recovery
"""

from .expert import grouped_conv2d_ep  # noqa: F401
from .halo import spatial_conv2d  # noqa: F401
from .mesh import (  # noqa: F401
    batch_sharding, conv_ic_tp, gemm_kdim_tp, make_mesh, shard_params,
    sharded_inference_fn,
)
from .multihost import (  # noqa: F401
    SliceRecovery, distributed_init, distributed_shutdown,
    host_local_batch_to_global, make_hybrid_mesh,
)
from .pipeline import pipeline_apply, stack_stage_params  # noqa: F401
