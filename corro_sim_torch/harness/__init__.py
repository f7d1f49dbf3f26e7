"""Host-side harness: the live cluster runtime."""

from corro_sim_torch.harness.cluster import LiveCluster  # noqa: F401
