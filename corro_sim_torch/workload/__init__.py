"""Production workload engine: traffic generators and the shared
changeset injection (:mod:`corro_sim_torch.workload.inject`)."""

from corro_sim_torch.workload.generators import (
    WORKLOADS,
    Workload,
    empty_slice,
    empty_workload,
    make_workload,
    parse_workload_spec,
)

__all__ = [
    "WORKLOADS",
    "Workload",
    "empty_slice",
    "empty_workload",
    "make_workload",
    "parse_workload_spec",
]
