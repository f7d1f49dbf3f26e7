"""Transfer guard: refuse host reads of device values outside the chunk
loop's sanctioned points.

The counterpart of ``corro_sim/analysis/transfer_guard.py``. The
pipelined loop only overlaps the host with the card while nothing in it
waits for the card outside its known read points; a stray ``.item()``
on the step path re-serializes dispatch. Armed, this turns such a read
into an error.

``guarded(True, device)`` arms the guard over a region:

- on a CUDA device, ``torch.cuda.set_sync_debug_mode("error")``: every
  synchronizing call torch checks (``.item()`` and the scalar
  conversions, ops whose output shape depends on data, blocking copies
  either way) raises;
- on the CPU, where that mode does nothing, a
  :class:`~torch.utils._python_dispatch.TorchDispatchMode` that raises
  on the ops that read a tensor's value to the host:
  ``aten._local_scalar_dense`` (``.item()``, ``bool()``, ``float()``,
  ``int()``), the ops whose output shape depends on data (``nonzero``,
  ``masked_select``, boolean indexing, ``unique``, ``repeat_interleave``
  without an output size), and copies from another device to the CPU.
  It cannot see ``.numpy()`` or ``.tolist()`` of a tensor already on
  the CPU, which dispatch nothing. It costs Python time per op while
  armed, nothing while off.

``sanctioned(point)`` re-opens the guard for one known read and counts
it on ``corro_lint_sanctioned_transfers_total{point=...}`` (and in
:func:`point_counts`). The driver arms the guard when ``run_sim(...,
transfer_guard=True)`` or ``CORRO_SIM_TRANSFER_GUARD=1``; it is off by
default.
"""

from __future__ import annotations

import contextlib
import os
from collections import Counter

# sanctioned reads by point since the process started (the metric's
# values, readable without rendering the registry)
_COUNTS: Counter = Counter()
# depth of open sanctioned points: the CPU mode lets reads through
# while it is nonzero
_OPEN = [0]
# depth of armed guarded regions
_ARMED = [0]


class HostSyncError(RuntimeError):
    """A host read of a device value inside a guarded region, outside
    every sanctioned point."""


def env_enabled() -> bool:
    """The debug flag: CORRO_SIM_TRANSFER_GUARD=1 arms the guard."""
    return os.environ.get(
        "CORRO_SIM_TRANSFER_GUARD", ""
    ).lower() not in ("", "0", "false")


def armed() -> bool:
    """Whether a guarded region is armed: the step's own sanctioned
    reads count only then."""
    return _ARMED[0] > 0


def point_counts() -> dict:
    """Sanctioned reads by point so far in this process."""
    return dict(_COUNTS)


def _host_read(func, args, kwargs) -> str | None:
    """Why ``func`` on these arguments reads a value to the host, or
    None."""
    import torch

    aten = torch.ops.aten
    name = func.overloadpacket.__name__
    if name in ("_local_scalar_dense", "nonzero", "masked_select",
                "_unique", "_unique2", "unique_dim", "unique_consecutive",
                "equal", "bincount"):
        return name
    if name == "repeat_interleave" and func in (
            aten.repeat_interleave.Tensor,
            aten.repeat_interleave.self_Tensor) and kwargs.get(
            "output_size") is None:
        return "repeat_interleave without output_size"
    if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        for t in idx or ():
            if isinstance(t, torch.Tensor) and t.dtype in (torch.bool,
                                                           torch.uint8):
                return f"{name} with a boolean mask"
    if name in ("_to_copy", "copy_", "to"):
        src = args[1] if name == "copy_" else args[0]
        dst_dev = (args[0].device if name == "copy_"
                   else kwargs.get("device"))
        if (isinstance(src, torch.Tensor) and dst_dev is not None
                and torch.device(dst_dev).type == "cpu"
                and src.device.type != "cpu"):
            return "copy to the CPU"
    return None


def _cpu_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _HostReadGuard(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not _OPEN[0]:
                why = _host_read(func, args, kwargs)
                if why is not None:
                    raise HostSyncError(
                        f"host read of a device value ({why}: {func}) "
                        "inside a guarded region, outside every "
                        "sanctioned point (analysis/transfer_guard.py)")
            return func(*args, **kwargs)

    return _HostReadGuard()


def _is_cuda(device) -> bool:
    import torch

    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def guarded(enabled: bool, device=None):
    """Arm the guard over the region when ``enabled`` (a no-op
    otherwise): the sync debug mode on a CUDA ``device``, the CPU
    dispatch mode on the CPU. ``device``: the run's device (default
    ``cuda`` where a card is visible). Yields whether it is armed."""
    if not enabled:
        yield False
        return
    _ARMED[0] += 1
    opened, _OPEN[0] = _OPEN[0], 0
    try:
        if _is_cuda(device):
            import torch

            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield True
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        else:
            with _cpu_mode():
                yield True
    finally:
        _OPEN[0] = opened
        _ARMED[0] -= 1


@contextlib.contextmanager
def sanctioned(point: str, enabled: bool = True):
    """Let host reads through at one sanctioned point of a guarded
    region, counting it:

      chunk_stage        host→device: a chunk's keys, schedule rows
                         and staged workload rows
      metric_fetch_start device→host: the copy of a chunk's packed
                         metric stacks, started at dispatch (pipelined
                         loop)
      metric_resolve     device→host: those stacks, read at commit
      metric_peek        the same stacks read early, once landed, to cut
                         a speculative chunk that will be discarded
      probe_extract      device→host: the per-chunk probe planes
      invariants         device→host: the checkers' planes at a chunk
                         boundary and at convergence
      checkpoint         device→host: the state a checkpoint writes
      sync_gate          device→host: the adaptive sweep gate's
                         predicate, one bool per floor-cadence round the
                         host data cannot decide (the step's own point)
      mesh_agree         the ranks' agreement that a copy landed (one
                         all-reduce of one int, under a mesh)
      mesh_gather        the host readers' leaves gathered onto rank 0
                         (under a mesh)
    """
    if not enabled:
        yield
        return
    import torch

    from corro_sim_torch.utils.metrics import (
        LINT_SANCTIONED_TRANSFERS_TOTAL,
        counters,
    )

    _COUNTS[point] += 1
    counters.inc(
        LINT_SANCTIONED_TRANSFERS_TOTAL,
        labels=f'{{point="{point}"}}',
        help_="transfers through the chunk loop's sanctioned points "
              "while the transfer guard is armed (analysis/"
              "transfer_guard.py)",
    )
    cuda = torch.cuda.is_available()
    prev = torch.cuda.get_sync_debug_mode() if cuda else 0
    if cuda:
        torch.cuda.set_sync_debug_mode(0)
    _OPEN[0] += 1
    try:
        yield
    finally:
        _OPEN[0] -= 1
        if cuda:
            torch.cuda.set_sync_debug_mode(prev)
