"""What each rank runs: the mesh entry points behind the command line,
the parity tests and the chip smoke.

Every function here is called on every rank of a world started by
:func:`corro_sim_torch.engine.ranks.run_ranks` (they are module-level so
the spawned ranks can import them) and returns host data — numpy arrays,
dicts — which the launcher hands back from rank 0.
"""

from __future__ import annotations

import numpy as np
import torch


def random_lanes(seed: int, n: int, cells: int, cap: int, m: int):
    """Flat cell lanes for the mesh merge checks, from a numpy seed:
    destinations over every shard, ranks past ``cap``, invalid lanes and
    (through the caller's padding) padded ones; each lane's mailbox rank
    is its rank within its destination over the global order, as the
    delivery pass computes it. Returns ``(planes, lanes)`` as numpy:
    ``cv``, ``vr``, ``site`` ``(n, cells)``, ``cl`` ``(n, cells // 2)``,
    and ``dst, rank, cell, cv, vr, site, cl, valid`` ``(m,)``."""
    rng = np.random.default_rng(seed)
    cols = 2
    rows = cells // cols
    planes = {
        "cv": rng.integers(0, 4, (n, cells)).astype(np.int32),
        "vr": rng.integers(-3, 6, (n, cells)).astype(np.int32),
        "site": rng.integers(-1, n, (n, cells)).astype(np.int32),
        "cl": rng.integers(0, 3, (n, rows)).astype(np.int32),
    }
    dst = np.sort(rng.integers(0, n, m)).astype(np.int32)
    valid = rng.random(m) < 0.8
    # rank within dst among valid lanes, in the global lane order
    rank = np.zeros(m, np.int32)
    seen: dict = {}
    for i in range(m):
        if valid[i]:
            rank[i] = seen.get(int(dst[i]), 0)
            seen[int(dst[i])] = rank[i] + 1
    # shuffle so lanes of one dst sit on several source shards
    perm = rng.permutation(m)
    lanes = {
        "dst": dst[perm], "rank": rank[perm],
        "cell": rng.integers(0, cells, m).astype(np.int32)[perm],
        "cv": rng.integers(0, 5, m).astype(np.int32),
        "vr": rng.integers(-3, 6, m).astype(np.int32),
        "site": rng.integers(0, n, m).astype(np.int32),
        "cl": rng.integers(0, 4, m).astype(np.int32),
        "valid": valid[perm],
    }
    return planes, lanes, cols


def _planes_state(planes, cols, lo, hi, dev):
    from corro_sim_torch.core.crdt import TableState

    n_l = hi - lo
    rows = planes["cv"].shape[1] // cols

    def t(k):
        return torch.as_tensor(planes[k][lo:hi].copy(), device=dev)

    return TableState(cv=t("cv").reshape(n_l, rows, cols),
                      vr=t("vr").reshape(n_l, rows, cols),
                      site=t("site").reshape(n_l, rows, cols),
                      cl=t("cl"))


def _gathered(mesh, st) -> dict:
    n_l = st.cv.shape[0]
    return {k: mesh.gather(getattr(st, k).reshape(n_l, -1)).cpu().numpy()
            for k in ("cv", "vr", "site", "cl")}


def merge_job(kind: str, seed: int, n: int, cells: int, cap: int,
              m: int) -> dict:
    """Run one mesh merge form on every rank and return the gathered
    planes: ``kind`` ``"route"`` (:func:`route_merge_sharded` on this
    rank's slice of the padded lane stream) or ``"grouped"``
    (:func:`merge_grouped` with ``mesh=`` on this rank's node-major
    mailbox slice)."""
    from corro_sim_torch.core.merge_kernel import (
        merge_grouped,
        route_lanes,
        route_merge_sharded,
    )
    from corro_sim_torch.engine.sharding import make_mesh

    mesh = make_mesh()
    dev = mesh.device
    planes, lanes, cols = random_lanes(seed, n, cells, cap, m)
    lo, hi = mesh.bounds(n)
    st = _planes_state(planes, cols, lo, hi, dev)
    lt = {k: torch.as_tensor(v.copy(), device=dev) for k, v in lanes.items()}
    if kind == "route":
        d = mesh.nodes
        pad = (-m) % d
        if pad:
            lt = {k: torch.cat([v, torch.zeros(pad, dtype=v.dtype,
                                               device=dev)])
                  for k, v in lt.items()}
        ml = (m + pad) // d
        a, b = mesh.index * ml, (mesh.index + 1) * ml
        sl = {k: v[a:b] for k, v in lt.items()}
        st = route_merge_sharded(
            st, sl["dst"], sl["rank"], sl["cell"], sl["cv"], sl["vr"],
            sl["site"], sl["cl"], sl["valid"], cap, mesh)
    else:
        box = route_lanes(lt["dst"], lt["rank"], lt["cell"], lt["cv"],
                          lt["vr"], lt["site"], lt["cl"], lt["valid"], n,
                          cap)
        st = merge_grouped(st, box[:, lo * cap:hi * cap].contiguous(), cap,
                           mesh=mesh)
    return _gathered(mesh, st)


def _cfg(cfg_dict):
    from corro_sim_torch.config import SimConfig, sim_config_from_dict

    if isinstance(cfg_dict, SimConfig):
        return cfg_dict
    return sim_config_from_dict(cfg_dict)


def _result_host(res, cfg, mesh, include_state: bool = True) -> dict:
    """A RunResult as host data (rank 0 pickles it back); the state
    gathered onto rank 0's host, as ``convert.state_to_numpy`` spells
    it."""
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.engine.sharding import gather_state, mesh_shardings
    from corro_sim_torch.utils.metrics import CONFIG_DOWNGRADE_TOTAL, counters

    out = {
        "metrics": {k: np.asarray(v) for k, v in res.metrics.items()},
        "rounds": res.rounds,
        "converged_round": res.converged_round,
        "repair_chunks": res.repair_chunks,
        "sharding": res.sharding,
        "pipeline": res.pipeline,
        "flight_events": (res.flight.events("config_downgrade")
                          if res.flight is not None else []),
        "downgrade_total": sum(
            v for (name, _), v in counters._c.items()
            if name == CONFIG_DOWNGRADE_TOTAL),
    }
    if include_state:
        whole = gather_state(res.state, mesh, mesh_shardings(cfg, mesh))
        out["state"] = None if whole is None else state_to_numpy(whole)
    return out


def run_sim_job(cfg_dict, seed: int, run_kwargs: dict, write_rounds=8,
                workload_spec=None) -> dict:
    """``run_sim(mesh=make_mesh())`` on every rank; rank 0's host copy
    of the gathered result. ``write_rounds`` None takes ``Schedule``'s
    default; ``workload_spec``: ``(spec, rounds, seed)`` of a compiled
    workload to feed."""
    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.engine.sharding import make_mesh
    from corro_sim_torch.engine.state import init_state

    cfg = _cfg(cfg_dict)
    mesh = make_mesh()
    state = init_state(cfg, seed=seed, device="cpu", mesh=mesh)
    workload = None
    if workload_spec is not None:
        from corro_sim_torch.workload import make_workload

        spec, rounds, wseed = workload_spec
        workload = make_workload(spec, cfg.num_nodes, rounds=rounds,
                                 seed=wseed)
    schedule = (Schedule() if write_rounds is None
                else Schedule(write_rounds=write_rounds))
    res = run_sim(cfg, state, schedule,
                  mesh=mesh, workload=workload, device=mesh.device,
                  **run_kwargs)
    return _result_host(res, cfg, mesh)


def batch(calls: list) -> list:
    """Run ``calls`` — ``(name, args, kwargs)`` of this module's jobs —
    one after another on the same world; return their results."""
    return [globals()[name](*args, **kwargs) for name, args, kwargs in calls]


def placement_job(cfg_dict, seed: int, rounds: int) -> dict:
    """Shard ``cfg``'s state, then run ``rounds`` mesh rounds under an
    :class:`AllocationWatch` on every rank. Returns the most axes of
    length N that any tensor a round allocated had, over every rank, the
    count of allocations and the worst shapes."""
    from corro_sim_torch import prng
    from corro_sim_torch.engine.driver import chunk_keys
    from corro_sim_torch.engine.sharding import make_mesh
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.engine.step import sim_step

    cfg = _cfg(cfg_dict)
    mesh = make_mesh()
    n = cfg.num_nodes
    state = init_state(cfg, seed=seed, device="cpu", mesh=mesh)
    keys = chunk_keys(prng.PRNGKey(seed), 0, rounds)
    alive = torch.ones(n, dtype=torch.bool, device=mesh.device)
    part = torch.zeros(n, dtype=torch.int32, device=mesh.device)
    watch = AllocationWatch(n)
    # one unwatched round first: it builds the placement cache
    state, _ = sim_step(cfg, state, keys[0], alive, part, True, 0, mesh=mesh)
    with watch():
        for r in range(1, rounds):
            state, _ = sim_step(cfg, state, keys[r], alive, part, True, r,
                                mesh=mesh)
    worst = int(mesh.reduce(torch.tensor(watch.worst), "max"))
    count = int(mesh.reduce(torch.tensor(watch.count)))
    return {"max_n_axes": worst, "allocations": count,
            "shapes": watch.shapes}


def gather_job(cfg_dict, seed: int) -> dict:
    """Build this rank's shard with ``init_state(mesh=)`` and gather it
    onto rank 0's host under an :class:`AllocationWatch`. Returns, from
    rank 0: the most axes of length N of any tensor the build allocated
    on any rank, the count of tensors with two such axes the gather
    allocated on rank 0 and on the other ranks, how many leaves of the
    whole state have two, and whether the gathered state equals
    ``init_state`` built whole."""
    from corro_sim_torch.convert import _leaves
    from corro_sim_torch.engine.sharding import (
        gather_state,
        make_mesh,
        mesh_shardings,
    )
    from corro_sim_torch.engine.state import init_state

    cfg = _cfg(cfg_dict)
    mesh = make_mesh()
    n = cfg.num_nodes
    build = AllocationWatch(n)
    with build():
        state = init_state(cfg, seed=seed, device=mesh.device, mesh=mesh)
    specs = mesh_shardings(cfg, mesh)
    watch = AllocationWatch(n)
    with watch():
        whole = gather_state(state, mesh, specs)
    others = 0 if mesh.index == 0 else watch.big
    out = {
        "build_max_n_axes": int(mesh.reduce(torch.tensor(build.worst),
                                             "max")),
        "rank0_big": watch.big,
        "others_big": int(mesh.reduce(torch.tensor(others))),
    }
    if whole is not None:
        ref = dict(_leaves(init_state(cfg, seed=seed, device="cpu")))
        got = dict(_leaves(whole))
        out["big_leaves"] = sum(
            1 for t in got.values()
            if sum(1 for s in t.shape if s == n) >= 2)
        out["equal"] = got.keys() == ref.keys() and all(
            torch.equal(got[k], ref[k]) for k in ref)
    return out


class AllocationWatch:
    """A ``TorchDispatchMode`` factory that records every tensor the
    operations inside it return that holds memory (not meta, not fake),
    the most axes of length ``n`` any of them had, and how many had two
    or more (``big``)."""

    def __init__(self, n: int):
        self.n = n
        self.worst = 0
        self.count = 0
        self.big = 0
        self.shapes: dict = {}

    def __call__(self):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        watch = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in (out if isinstance(out, (tuple, list))
                          else (out,)):
                    if (isinstance(t, torch.Tensor) and not t.is_meta
                            and not isinstance(t, FakeTensor)):
                        k = sum(1 for s in t.shape if s == watch.n)
                        watch.count += 1
                        watch.big += k >= 2
                        if k >= max(watch.worst, 1):
                            watch.shapes[str(func)] = tuple(t.shape)
                        watch.worst = max(watch.worst, k)
                return out

        return _Mode()


def bench_job(name: str, kwargs: dict) -> dict:
    """One bench leg (``benchmarks.run_config_*``) on every rank of the
    world, on the CPU; rank 0's artifact line."""
    from corro_sim_torch import benchmarks

    return getattr(benchmarks, name)(device="cpu", **kwargs)


def sweep_job(plan, run_kwargs: dict, node_shards: int = 1) -> list:
    """``run_sweep(plan, mesh=make_sweep_mesh(...))`` on every rank;
    rank 0's lane results as host data."""
    from corro_sim_torch.engine.sharding import make_sweep_mesh
    from corro_sim_torch.sweep.engine import run_sweep

    mesh = make_sweep_mesh(plan.num_lanes, node_shards=node_shards)
    res = run_sweep(plan, mesh=mesh, device=mesh.device, **run_kwargs)
    return res


