"""Device-mesh placement: shard the cluster over the node axis.

Port of ``corro_sim/engine/sharding.py`` on ``torch.distributed``. The
JAX package annotates shardings and lets GSPMD insert the collectives;
the port runs one process per rank, each holding its slice of every
node-sharded leaf, and the step calls the collectives itself
(:class:`Mesh`'s methods; ``engine/step.py`` with ``mesh=``).

Placement (:func:`state_shardings`) is the JAX package's: node-leading
leaves shard over the ``"nodes"`` axis, the change log shards over its
actor axis under ``shard_log`` and is replicated otherwise, and ``own``,
``row_cdf``, ``inflight``, the scalars and the disabled placeholders are
replicated. Inside a round the port splits the node-sharded leaves in
two (:func:`is_row_plane`):

- the row planes — the table, ``book.head`` and ``book.win``, the
  full-view SWIM plane, ``rtt``, ``cleared_hlc``, the stale-rejoin
  snapshot and, under ``shard_log``, the log's per-version planes — stay
  sliced: a stage
  that reads another node's row fetches just those rows
  (:meth:`Mesh.fetch_rows`), and a stage that writes one routes the
  write to its owner;
- the O(N·k) leaves (the ``(N,)`` vectors, ``ring0``, the gossip ring,
  windowed SWIM's planes, the probe tracer's node axis, the log heads)
  are all-gathered when the round starts, advanced on every rank alike
  and sliced again when it ends (:func:`gather_small`,
  :func:`slice_small`).

The resident bytes (:func:`state_bytes_breakdown`) are computed on the
``meta`` device, so nothing is allocated. The port keeps some leaves in
wider carriers than the JAX package (``convert.WIDENED``: the book
window and the SWIM planes ride int64 or int32), so its bytes are larger
than the JAX package's for the same config, by those leaves' extra
bytes.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import torch

from corro_sim_torch.convert import _leaves

# The step's explicit collectives at the delivery merge site: one
# all_to_all of the routed lane buckets (core/merge_kernel.py
# route_merge_sharded), the JAX package's collective-budget contract.
DELIVERY_EXCHANGE_COLLECTIVES: dict[str, int] = {"all_to_all": 1}

# Past this many actors the change log takes the actor-sharded layout.
SHARD_LOG_ACTORS = 2048

# The CPU counterpart of XLA's --xla_force_host_platform_device_count:
# how many gloo ranks `run --mesh` and `sweep --mesh` start on the CPU.
MESH_RANKS_ENV = "CORRO_SIM_MESH_RANKS"


def visible_devices(device=None) -> int:
    """How many devices a mesh could span: the cards on CUDA, else the
    CPU rank count of :data:`MESH_RANKS_ENV` (1 when unset)."""
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda":
        return torch.cuda.device_count()
    return max(1, int(os.environ.get(MESH_RANKS_ENV, "1") or 1))


def _bool_carrier(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8) if x.dtype == torch.bool else x


class Mesh:
    """A named grid of ranks of ``torch.distributed``.

    ``axis_names`` ``("nodes",)`` (:func:`make_mesh`) or ``("sweep",
    "nodes")`` (:func:`make_sweep_mesh`); ``shape`` maps each axis to its
    size; ``coords`` this rank's index on each (None for a rank outside
    the mesh); ``group`` the process group of this rank's ``"nodes"``
    axis, over which the step's collectives run; ``device`` this rank's
    device (``cuda:{local rank}`` on cards, ``cpu`` otherwise);
    ``host_group`` the same ranks over gloo, for host-side agreement
    (:meth:`agree`)."""

    def __init__(self, axis_names, shape: dict, coords: dict | None,
                 group, device, ranks=None, host_group=None):
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        self.coords = coords
        self.group = group
        # the "nodes" group over gloo, for decisions taken on the host
        # (the group itself where the world runs gloo)
        self.host_group = group if host_group is None else host_group
        self.device = torch.device(device)
        self.ranks = list(ranks) if ranks is not None else []
        self.sweep_group = None  # the "sweep" axis's group (sweep meshes)

    @property
    def size(self) -> int:
        out = 1
        for v in self.shape.values():
            out *= v
        return out

    @property
    def nodes(self) -> int:
        """Ranks on the ``"nodes"`` axis: the shards of one cluster."""
        return self.shape.get("nodes", 1)

    @property
    def index(self) -> int:
        """This rank's shard index on the ``"nodes"`` axis."""
        return (self.coords or {}).get("nodes", 0)

    def __repr__(self) -> str:
        return (f"Mesh(axes={self.axis_names}, shape={self.shape}, "
                f"coords={self.coords}, device={self.device})")

    # -------------------------------------------------------- collectives
    # Every method is collective over the "nodes" group: each rank of it
    # must call it, in the same order, with the same shapes where noted.
    # A mesh without a process group (a placement description, or a
    # "nodes" axis of one rank in a sweep mesh) calls nothing; a world of
    # one rank still runs its collectives, so a one-rank NCCL mesh
    # exercises them.

    def _local(self) -> bool:
        return self.group is None

    def bounds(self, n: int) -> tuple[int, int]:
        """``(lo, hi)``: the rows of an ``n``-row axis this rank holds."""
        d = self.nodes
        if n % d:
            raise ValueError(f"{n} rows do not split over {d} shards")
        nl = n // d
        return self.index * nl, (self.index + 1) * nl

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes), concatenated on axis 0 in
        rank order."""
        d = self.nodes
        if self._local():
            return x
        src = _bool_carrier(x).contiguous()
        parts = [torch.empty_like(src) for _ in range(d)]
        torch.distributed.all_gather(parts, src, group=self.group)
        out = torch.cat(parts) if src.dim() else torch.stack(parts)
        return out.to(x.dtype) if x.dtype == torch.bool else out

    def reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise ``sum``, ``max`` or ``min`` of every rank's ``x``
        (equal shapes), returned on every rank. Integer sums are exact,
        so a sum of disjoint parts equals the one-device value."""
        if self._local():
            return x
        red = {"sum": torch.distributed.ReduceOp.SUM,
               "max": torch.distributed.ReduceOp.MAX,
               "min": torch.distributed.ReduceOp.MIN}[op]
        y = _bool_carrier(x).clone().contiguous()
        if y.dim() == 0:
            y = y.reshape(1)
            torch.distributed.all_reduce(y, op=red, group=self.group)
            y = y.reshape(())
        else:
            torch.distributed.all_reduce(y, op=red, group=self.group)
        return y.to(x.dtype) if x.dtype == torch.bool else y

    def agree(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank: one reduction of a host
        integer over ``host_group``, so the answer waits on no device
        queue."""
        if self._local() or self.nodes == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN,
                                     group=self.host_group)
        return bool(t.item())

    def gather_to(self, x: torch.Tensor, dst: int = 0):
        """Every rank's ``x`` (equal shapes, at least one axis),
        concatenated on axis 0 in rank order, on the host of rank
        ``dst``; None on the others. The parts come one at a time
        (point-to-point), each copied to the host before the next is
        received, so no rank's device holds more than its own part and
        one received part."""
        if self._local():
            return x.cpu()
        src = _bool_carrier(x).contiguous()
        nl, me = src.shape[0], self.index
        out = buf = None
        if me == dst:
            out = torch.empty((self.nodes * nl,) + tuple(src.shape[1:]),
                              dtype=src.dtype)
            out[dst * nl:(dst + 1) * nl].copy_(src)
            buf = torch.empty_like(src)
        for r in range(self.nodes):
            if r == dst:
                continue
            if me == r:
                torch.distributed.send(
                    src, torch.distributed.get_global_rank(self.group, dst),
                    group=self.group)
            elif me == dst:
                torch.distributed.recv(
                    buf, torch.distributed.get_global_rank(self.group, r),
                    group=self.group)
                out[r * nl:(r + 1) * nl].copy_(buf)
        if out is None or x.dtype != torch.bool:
            return out
        return out.to(torch.bool)

    def exchange(self, counts: torch.Tensor, *payloads: torch.Tensor):
        """Send ``payloads`` (lanes on axis 0, grouped by destination
        rank in rank order, ``counts[r]`` lanes for rank ``r``) with one
        ``all_to_all_single`` each. Returns ``(recv_counts, *received)``:
        each rank receives the senders' lanes in sender order, so lanes
        that sit in a global order across consecutive senders arrive in
        that order."""
        counts = counts.to(torch.int64)
        if self._local():
            return (counts, *payloads)
        recv_counts = torch.empty_like(counts)
        torch.distributed.all_to_all_single(recv_counts, counts,
                                            group=self.group)
        sc = counts.tolist()
        rc = recv_counts.tolist()
        out = []
        for p in payloads:
            src = _bool_carrier(p).contiguous()
            dst = torch.empty((sum(rc),) + tuple(src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            torch.distributed.all_to_all_single(
                dst, src, output_split_sizes=rc, input_split_sizes=sc,
                group=self.group)
            out.append(dst.to(p.dtype) if p.dtype == torch.bool else dst)
        return (recv_counts, *out)

    def all_to_all(self, buckets: torch.Tensor) -> torch.Tensor:
        """One ``all_to_all_single`` of ``(D, ...)`` equal buckets:
        bucket ``r`` goes to rank ``r``; returns the received ``(D,
        ...)`` buckets in sender order."""
        if self._local():
            return buckets
        src = buckets.contiguous()
        out = torch.empty_like(src)
        torch.distributed.all_to_all_single(out, src, group=self.group)
        return out

    def fetch_rows(self, plane: torch.Tensor, idx: torch.Tensor,
                   rows: int | None = None) -> torch.Tensor:
        """``global_plane[idx]`` of a plane sliced over the ranks (this
        rank holds ``plane``, rows ``[index * nl, (index + 1) * nl)``):
        each rank sends the row numbers it wants to their owners and gets
        just those rows back (two ``all_to_all_single``). ``idx`` must be
        in range; ranks may ask for different numbers of rows."""
        nl = plane.shape[0] if rows is None else rows
        d = self.nodes
        flat = idx.reshape(-1).long()
        if self._local():
            return plane[flat].reshape(tuple(idx.shape)
                                       + tuple(plane.shape[1:]))
        owner = torch.div(flat, nl, rounding_mode="floor")
        order = torch.argsort(owner, stable=True)
        counts = torch.bincount(owner, minlength=d)
        recv_counts, want = self.exchange(counts, flat[order])
        lo = self.index * nl
        got = plane[want - lo]
        # reply: the requested rows back to their askers, in ask order
        sc = recv_counts.tolist()
        rc = counts.tolist()
        src = _bool_carrier(got).contiguous()
        back = torch.empty((flat.shape[0],) + tuple(src.shape[1:]),
                           dtype=src.dtype, device=src.device)
        torch.distributed.all_to_all_single(
            back, src, output_split_sizes=rc, input_split_sizes=sc,
            group=self.group)
        out = torch.empty_like(back)
        out[order] = back
        if plane.dtype == torch.bool:
            out = out.to(torch.bool)
        return out.reshape(tuple(idx.shape) + tuple(plane.shape[1:]))

    def fetch_elems(self, plane: torch.Tensor, row: torch.Tensor,
                    col: torch.Tensor) -> torch.Tensor:
        """``global_plane[row, col]`` of a 2-D plane sliced by rows: the
        elements fetched one word each (:meth:`fetch_rows` on the
        flattened plane)."""
        w = plane.shape[1]
        flat = plane.reshape(-1, 1)
        got = self.fetch_rows(flat, row.long() * w + col.long(),
                              rows=plane.shape[0] * w)
        return got[..., 0]

    def row_lookup(self, plane: torch.Tensor):
        """A ``(rows, cols) -> bool`` reader of a row-sliced plane for
        node-major callers (``rows[i]`` is node ``i`` along axis 0, as in
        the broadcast and sync peer tests): each rank reads its own rows'
        entries and the results are all-gathered."""
        lo_hi = None

        def read(rows, cols):
            nonlocal lo_hi
            n = rows.shape[0]
            if lo_hi is None:
                lo_hi = self.bounds(n)
            lo, hi = lo_hi
            r = rows[lo:hi].long() - lo
            part = plane[r, cols[lo:hi].long()]
            return self.gather(part)

        return read


# ------------------------------------------------------------ meshes


def _world():
    if not torch.distributed.is_available() or \
            not torch.distributed.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized torch.distributed world: start "
            "the ranks with corro_sim_torch.engine.ranks.run_ranks (or "
            "torchrun)"
        )
    return torch.distributed.get_rank(), torch.distributed.get_world_size()


def _rank_device():
    from corro_sim_torch.engine.ranks import rank_device

    return rank_device()


def _host_group(ranks, group):
    """A gloo group over ``ranks`` beside ``group`` where the world runs
    NCCL (every rank of the world must call this, in one order); the
    group itself under gloo or for one rank, which reduces nothing."""
    ranks = list(ranks)
    if torch.distributed.get_backend() == "gloo" or len(ranks) == 1:
        return group
    return torch.distributed.new_group(ranks, backend="gloo")


def make_mesh(devices=None) -> Mesh:
    """Every rank of the world on one ``"nodes"`` axis. ``devices``: a
    rank count to use (the first ranks of the world), default all."""
    rank, world = _world()
    d = world if devices is None else int(
        devices if isinstance(devices, int) else len(devices))
    if d > world:
        raise ValueError(f"mesh of {d} ranks in a world of {world}")
    group = (torch.distributed.group.WORLD if d == world
             else torch.distributed.new_group(list(range(d))))
    coords = {"nodes": rank} if rank < d else None
    return Mesh(("nodes",), {"nodes": d}, coords, group, _rank_device(),
                ranks=range(d), host_group=_host_group(range(d), group))


def make_sweep_mesh(lanes: int, devices=None, node_shards: int = 1) -> Mesh:
    """A mesh for the fleet sweep: the lane axis on ``"sweep"`` and, with
    ``node_shards`` > 1, each lane group's nodes on ``"nodes"``. Uses the
    most ranks that divide the lane count evenly; ranks past them idle
    (``coords`` None)."""
    rank, world = _world()
    avail = world if devices is None else int(
        devices if isinstance(devices, int) else len(devices))
    per_lane = max(1, int(node_shards))
    usable = avail // per_lane
    sweep_devs = 1
    for d in range(min(usable, lanes), 0, -1):
        if lanes % d == 0:
            sweep_devs = d
            break
    used = sweep_devs * per_lane
    sweep_group = (torch.distributed.group.WORLD if used == world
                   else torch.distributed.new_group(list(range(used))))
    # every rank builds every lane group's process group, in one order
    groups, hosts = [], []
    for s in range(sweep_devs):
        lane_ranks = range(s * per_lane, (s + 1) * per_lane)
        g = (torch.distributed.new_group(list(lane_ranks))
             if per_lane > 1 else None)
        groups.append(g)
        hosts.append(_host_group(lane_ranks, g) if g is not None else None)
    coords, group, host = None, None, None
    if rank < used:
        s, j = divmod(rank, per_lane)
        coords = {"sweep": s, "nodes": j}
        group, host = groups[s], hosts[s]
    mesh = Mesh(("sweep", "nodes"), {"sweep": sweep_devs,
                                     "nodes": per_lane},
                coords, group, _rank_device(), ranks=range(used),
                host_group=host)
    mesh.sweep_group = sweep_group
    return mesh


def check_compact_mesh(mesh: Mesh | None) -> None:
    """Refuse a mesh with a compacted or pipelined sweep: compaction
    re-packs the lane axis into power-of-2 buckets at chunk boundaries,
    so the lane-batch width changes mid-run and cannot stay divided over
    the ranks."""
    if mesh is not None and mesh.size > 1:
        raise ValueError(
            "compacted/pipelined sweep dispatch does not compose with a "
            "device mesh: lane-batch widths change at re-pack "
            "boundaries (power-of-2 buckets), which breaks the static "
            "width-divides-devices sharding rule. Drop --mesh-lanes or "
            "drop --compact/--pipeline."
        )


# --------------------------------------------------------- placement


def resolve_shard_log(cfg=None, num_actors: int | None = None,
                      shard_log: bool | None = None) -> bool:
    """The change-log regime: an explicit ``shard_log`` (the argument,
    else ``SimConfig.shard_log``) beats the ``SHARD_LOG_ACTORS`` shape
    rule."""
    if shard_log is None and cfg is not None:
        shard_log = getattr(cfg, "shard_log", None)
    if shard_log is not None:
        return bool(shard_log)
    if num_actors is None:
        num_actors = cfg.num_actors
    return num_actors >= SHARD_LOG_ACTORS


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives: ``spec`` ``("nodes",)`` (sliced on its
    leading axis) or ``()`` (replicated), as the JAX package's
    ``PartitionSpec``; ``("sweep",)`` and ``("sweep", "nodes")`` for the
    stacked sweep carry."""

    mesh: Mesh | None
    spec: tuple

    @property
    def sharded(self) -> bool:
        return "nodes" in self.spec


def _component(key: str) -> str:
    """``"book.win"`` -> ``"book"``; ``"features['x']"`` -> ``"features"``."""
    for i, ch in enumerate(key):
        if ch in ".[":
            return key[:i]
    return key


def _leaf_spec(key: str, t, num_nodes: int, shard_log: bool) -> tuple:
    """The JAX package's placement rule for one leaf of the state."""
    name = _component(key)
    node_axis = t.dim() >= 1 and t.shape[0] == num_nodes
    if name in ("own", "row_cdf", "round", "sync_rounds", "inflight"):
        return ()
    if key == "cleared_hlc":
        return ("nodes",)
    if name == "log":
        return ("nodes",) if shard_log and node_axis else ()
    return ("nodes",) if node_axis else ()


def _map_leaves(obj, fn, prefix: str = ""):
    """``obj`` rebuilt with ``fn(key, leaf)`` at every tensor (or
    :class:`Placement`) leaf, keys as ``convert._leaves`` spells them."""
    if isinstance(obj, (torch.Tensor, Placement)):
        return fn(prefix, obj)
    if isinstance(obj, dict):
        return {k: _map_leaves(v, fn, f"{prefix}['{k}']")
                for k, v in obj.items()}
    return dataclasses.replace(obj, **{
        f.name: _map_leaves(getattr(obj, f.name), fn,
                            f"{prefix}.{f.name}" if prefix else f.name)
        for f in dataclasses.fields(obj)
    })


def _specs(shardings) -> dict:
    """``{leaf key: Placement}`` of a placement tree."""
    out: dict = {}

    def put(key, p):
        out[key] = p
        return p

    _map_leaves(shardings, put)
    return out


def state_shardings(state, mesh: Mesh, num_nodes: int,
                    shard_log: bool | None = None):
    """A SimState-shaped tree of :class:`Placement`\\ s (node-axis data
    parallel; the log actor-sharded under ``shard_log``)."""
    shard_log = resolve_shard_log(num_actors=state.log.head.shape[0],
                                  shard_log=shard_log)
    return _map_leaves(state, lambda k, t: Placement(
        mesh, _leaf_spec(k, t, num_nodes, shard_log)))


@functools.lru_cache(maxsize=32)
def mesh_shardings(cfg, mesh: Mesh):
    """The placement of ``cfg``'s state on ``mesh``, from its whole
    shapes on the ``meta`` device (a rank's shard no longer shows which
    leaves were sliced)."""
    from corro_sim_torch.engine.state import init_state

    return state_shardings(init_state(cfg, seed=0, device="meta"), mesh,
                           cfg.num_nodes, shard_log=cfg.shard_log)


def sweep_state_shardings(cfg, stacked, mesh: Mesh):
    """Placements of the ``(L, ...)``-stacked sweep carry: every leaf's
    lane axis on ``"sweep"``, and with a ``"nodes"`` axis over one rank,
    node-sized axis-1 leaves on it too."""
    n = cfg.num_nodes
    node_shards = mesh.shape.get("nodes", 1)

    def one(_key, t):
        parts = ["sweep"]
        if (node_shards > 1 and t.dim() >= 2 and t.shape[1] == n
                and t.shape[1] % node_shards == 0):
            parts.append("nodes")
        return Placement(mesh, tuple(parts))

    return _map_leaves(stacked, one)


# The node-sharded leaves a round keeps sliced (module docstring): the
# planes whose other rows a stage fetches, never gathers.
_ROW_PLANES = ("table.", "book.", "swim.p", "rtt", "cleared_hlc",
               "log.cells", "log.ncells", "log.live", "log.cleared",
               "features['node_snapshot']")


def is_row_plane(key: str) -> bool:
    return any(key == p or key.startswith(p) for p in _ROW_PLANES)


def shard_state(state, mesh: Mesh, num_nodes: int,
                shard_log: bool | None = None):
    """This rank's slice of ``state``: each node-sharded leaf's rows
    ``[index * N/D, (index + 1) * N/D)``, replicated leaves whole, on the
    mesh's device."""
    sh = state_shardings(state, mesh, num_nodes, shard_log)
    specs = _specs(sh)

    def one(key, t):
        if specs[key].sharded:
            lo, hi = mesh.bounds(t.shape[0])
            return t[lo:hi].to(mesh.device).clone()
        return t.to(mesh.device)

    return _map_leaves(state, one)


def _picked(key: str, keys) -> bool:
    return keys is None or any(key == p or key.startswith(p) for p in keys)


def gather_state(state, mesh: Mesh, shardings, keys=None, dst: int = 0):
    """The whole state from every rank's slice (:func:`shard_state`'s
    inverse) on the host of rank ``dst`` of the ``"nodes"`` axis, for
    results, tokens, checkpoints and the host-side checkers; None on the
    other ranks. Every rank of the axis must call it. A sharded leaf
    arrives one part at a time (:meth:`Mesh.gather_to`), so no device
    ever holds a whole ``(N, N)`` plane. ``keys``: gather only the
    leaves whose key starts with one of these prefixes (keys as
    ``convert._leaves`` spells them); the others are None."""
    specs = _specs(shardings)
    reader = mesh._local() or mesh.index == dst

    def one(key, t):
        if not _picked(key, keys):
            return None
        if specs[key].sharded:
            return mesh.gather_to(t, dst)
        return t.cpu() if reader else None

    out = _map_leaves(state, one)
    return out if reader else None


def gather_small(state, mesh: Mesh, shardings):
    """A round's entry: the node-sharded leaves that are not row planes
    gathered whole, the row planes left sliced."""
    specs = _specs(shardings)
    return _map_leaves(state, lambda k, t: mesh.gather(t)
                       if specs[k].sharded and not is_row_plane(k) else t)


def slice_small(state, mesh: Mesh, shardings):
    """A round's exit: :func:`gather_small`'s leaves sliced back."""
    specs = _specs(shardings)

    def one(key, t):
        if specs[key].sharded and not is_row_plane(key):
            lo, hi = mesh.bounds(t.shape[0])
            return t[lo:hi]
        return t

    return _map_leaves(state, one)


def gathered_bytes(state, shardings) -> dict:
    """``{leaf: bytes}`` each rank receives per round from
    :func:`gather_small` (the whole leaf less its own slice)."""
    specs = _specs(shardings)
    out = {}
    for key, t in _leaves(state):
        if specs[key].sharded and not is_row_plane(key):
            out[key] = t.numel() * t.element_size()
    return out


# ------------------------------------------------------------- bytes


def state_bytes_breakdown(cfg, sharded_over: int = 1,
                          shard_log: bool | None = None) -> dict:
    """``{component: {total, per_device, placement}}`` bytes of ``cfg``'s
    state under the node-axis layout, each sharded component's bytes
    split over ``sharded_over`` devices. ``shard_log`` overrides the
    change log's regime. Shape-only: the state is built on ``meta``."""
    from corro_sim_torch.engine.state import init_state

    state = init_state(cfg, seed=0, device="meta")
    shard_log = resolve_shard_log(cfg, shard_log=shard_log)
    out: dict = {}
    for key, t in _leaves(state):
        nbytes = t.numel() * t.element_size()
        name = _component(key)
        is_log = name == "log"
        node_axis = t.dim() >= 1 and t.shape[0] == cfg.num_nodes
        sharded = (node_axis and not is_log) or (
            is_log and shard_log and node_axis
        )
        comp = out.setdefault(
            name, {"total": 0, "per_device": 0, "placement": "replicated"},
        )
        comp["total"] += nbytes
        comp["per_device"] += nbytes // sharded_over if sharded else nbytes
        if sharded:
            comp["placement"] = "actor_sharded" if is_log else "node_sharded"
    return out


def state_bytes(cfg, sharded_over: int = 1,
                shard_log: bool | None = None) -> tuple[int, int]:
    """``(total, per_device)`` resident bytes of ``cfg``'s state over
    ``sharded_over`` devices."""
    breakdown = state_bytes_breakdown(cfg, sharded_over=sharded_over,
                                      shard_log=shard_log)
    return (
        sum(c["total"] for c in breakdown.values()),
        sum(c["per_device"] for c in breakdown.values()),
    )


def sharding_report(cfg, sharding: dict) -> dict:
    """A run's placement block: ``RunResult.sharding`` plus the
    per-component :func:`state_bytes_breakdown` at the run's own mesh
    size."""
    return dict(
        sharding,
        state_bytes=state_bytes_breakdown(
            cfg,
            sharded_over=max(int(sharding.get("devices", 1)), 1),
            shard_log=sharding.get("shard_log") == "actor_sharded",
        ),
    )
