"""Distributed launch layer of the port: meshes over ``torch.distributed``
with the H100's roofline constants, the logical-axis sharding rules as
``DTensor`` placements, the dry-run's programs, its roofline and the
dry-run itself (``python -m repro_torch.launch.dryrun``), and the train
and serve entry points (``python -m repro_torch.launch.serve``)."""
from repro_torch.launch.mesh import (
    HBM_BANDWIDTH, NETWORK_BANDWIDTH, NVLINK_BANDWIDTH, PEAK_FLOPS_BF16,
    make_host_mesh, make_production_mesh,
)
from repro_torch.launch.sharding import (
    RULE_SETS, SERVE_RULES, TRAIN_RULES, resolve_pspec, sharded_bytes,
    sharding_tree,
)

__all__ = [
    "HBM_BANDWIDTH", "NETWORK_BANDWIDTH", "NVLINK_BANDWIDTH",
    "PEAK_FLOPS_BF16", "make_host_mesh", "make_production_mesh",
    "RULE_SETS", "SERVE_RULES", "TRAIN_RULES", "resolve_pspec",
    "sharded_bytes", "sharding_tree",
]
