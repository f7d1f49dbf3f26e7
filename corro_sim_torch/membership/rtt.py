"""Link latency model and measured-RTT rings: the ``members.rs`` analog.

Port of ``corro_sim/membership/rtt.py``. Three pieces:

- **Delay model**: nodes belong to ``latency_regions`` contiguous
  regions. A link's delay in rounds is ``latency_intra`` (1, same round)
  within a region and ``latency_inter`` across. Delayed lanes park in
  the step's in-flight ring (``SimState.inflight``) and deliver
  ``latency_inter - 1`` rounds after emission: latency, not loss.
- **Measurement**: every landed lane writes the observed edge delay into
  the receiver's ``rtt[dst, src]`` plane (``transport.rs:199-233``).
- **Ring recomputation**: every ``ring_update_interval`` rounds each node
  re-picks its ``ring0_size`` lowest-RTT peers from its observations
  (unobserved edges rank last; ``members.rs:140-188``).
"""

from __future__ import annotations

import torch

from corro_sim_torch.utils.sort import scatter_set, top_k

UNOBSERVED = 255


def region_of(cfg, node: torch.Tensor) -> torch.Tensor:
    return (node.to(torch.int64) * cfg.latency_regions) // cfg.num_nodes


def link_delay(cfg, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """int32 delay in rounds of each ``(src, dst)`` lane."""
    same = region_of(cfg, src) == region_of(cfg, dst)
    return torch.where(same, cfg.latency_intra, cfg.latency_inter).to(
        torch.int32)


def make_rtt(num_nodes: int, enabled: bool, device) -> torch.Tensor:
    """The ``(N, N)`` uint8 plane, all unobserved; ``(1, 1)`` when off."""
    n = num_nodes if enabled else 1
    return torch.full((n, n), UNOBSERVED, dtype=torch.uint8, device=device)


def observe_rtt(cfg, rtt: torch.Tensor, dst: torch.Tensor, src: torch.Tensor,
                delivered: torch.Tensor) -> torch.Tensor:
    """``rtt`` with the observed delay of every delivered lane set at
    ``[dst, src]``. The delay is fixed per edge, so duplicate lanes carry
    equal samples and the order of the writes does not matter; lanes not
    delivered write nothing."""
    sample = torch.clamp(link_delay(cfg, src, dst), 0, 254).to(torch.uint8)
    return scatter_set(rtt, (dst, src), sample, delivered)


def recompute_ring0(rtt: torch.Tensor, ring0: torch.Tensor) -> torch.Tensor:
    """Each node's ``ring0_size`` lowest-observed-RTT peers.

    Unobserved peers rank behind every observed one and self is never
    picked. Ties, and the all-unobserved cold start, break toward the
    current ring's members (a bonus of 1 under a score scaled by 4), then
    toward the lower index, as ``jax.lax.top_k`` does."""
    n, k = ring0.shape
    score = rtt.to(torch.int32)  # 255 = unobserved
    score.fill_diagonal_(1000)  # never pick self
    bonus = torch.zeros((n, n), dtype=torch.int32, device=rtt.device)
    bonus.scatter_(1, ring0.long(), 1)
    _, new_ring = top_k(-(score * 4 - bonus), k)
    return new_ring.to(torch.int32)
