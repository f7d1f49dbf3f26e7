"""Run one cell of the port's benchmark and print its result line.

    python3 -m simbench.run --workload <config>.<traffic> --seed <n>
                            --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``simbench/``
and the port (``corro_sim_torch``). One run:

1. loads the cell's configuration, traffic mix and metric readers;
2. resolves the card, and fails without one (it never runs on the CPU);
3. builds or loads the merge kernel from the port's build cache
   (``corro_sim_torch/_build/`` in the checkout);
4. warms up on a throwaway cluster of the cell's own shapes;
5. measures for ``--seconds``: clusters of the cell run back to back
   through ``init_state`` and ``run_sim`` (the pipelined loop, the
   kernel on ``auto``), one client in a closed loop, cluster ``i`` keyed
   by ``schedule.cluster_seed(seed, i)``; the window closes at the first
   chunk boundary past its time, and rounds count up to there;
6. judges the sampled clusters' outputs against the plain reference
   (``simbench/reference/``) once the window has closed, and prints one
   JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``,
   ``device``, with ``--trace 1`` also ``breakdown``, and last
   ``checks``, each number compared beside its limit.

With ``--trace 1`` the metrics are the per-layer ones: the window runs
as above, with host ranges around the stages the metrics name, a
profiler over the rounds the traffic mix names in the first cluster,
and then the sample of calls a metric names (the merge's bytes).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

from simbench import cells as cells_mod  # noqa: E402
from simbench import schedule as sched  # noqa: E402
from simbench import trace as trace_mod  # noqa: E402
from simbench.reference import draws, oracle  # noqa: E402

HERE = Path(__file__).resolve().parent
OUT = HERE / "out"
FORBIDDEN = ("jax", "jaxlib", "flax", "corro_sim")
LIMITS = {name: 0 for name in oracle.CHECKS + ("unconverged", "none_judged")}


class WindowClosed(Exception):
    """Raised from ``run_sim``'s chunk callback once the window is over."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``corro_sim_torch`` is not ``corro_sim``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_env() -> None:
    """Keep every kernel cache inside the checkout, at fixed paths."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(OUT / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(OUT / "triton"))


def require_cards(chips: int):
    """The card the cell runs on; None, with the reason on standard
    error, where there are fewer than ``chips``."""
    import torch

    if not torch.cuda.is_available():
        print("simbench: no CUDA device; this benchmark runs only on the "
              "card", file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"simbench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_schedule(traffic: dict, n: int):
    from corro_sim_torch.engine.driver import Schedule

    return Schedule(
        write_rounds=int(traffic["write_rounds"]),
        alive_fn=lambda r, num: sched.alive_row(traffic, r, num),
        part_fn=lambda r, num: sched.part_row(traffic, r, num),
    )


def host_outputs(state) -> dict:
    """What the judge reads of a finished cluster, as numpy."""
    log_head = state.log.head.cpu().numpy()
    h = min(max(int(log_head.max()), 1), state.log.cells.shape[1])
    return {
        "cv": state.table.cv.cpu().numpy(),
        "vr": state.table.vr.cpu().numpy(),
        "site": state.table.site.cpu().numpy(),
        "cl": state.table.cl.cpu().numpy(),
        "head": state.book.head.cpu().numpy(),
        "log_head": log_head,
        "log_cells": state.log.cells[:, :h].cpu().numpy(),
        "log_ncells": state.log.ncells[:, :h].cpu().numpy(),
    }


class Profiler:
    """One ``torch.profiler`` session, written to a Chrome trace in
    ``simbench/out/`` when it stops."""

    def __init__(self, path: Path, device, host: bool = True):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if host else []
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.path = path
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()
        OUT.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None


class TracePlan:
    """The traced run's hooks: the clean profiled rounds of the first
    cluster, then the sample of calls the metrics name."""

    def __init__(self, cell, device):
        self.device = device
        self.plan = cell.traffic["trace"]
        self.session = None
        self.traced_rounds = 0
        self.done = False
        self.samplers = [(m["name"], mod) for m, mod in cell.per_layer
                         if getattr(mod, "SAMPLE", None)]
        self.works = {name: [] for name, _ in self.samplers}
        self.sampling = False
        self.sample_session = None
        self.restore = []
        # the traced rounds, the sample and the trace files' writing run
        # slower than the window; their seconds are held off its clock
        self.held = 0.0
        self.t_on = None

    # -- host ranges and sample wrappers, over the whole window
    def install(self, per_layer) -> None:
        import importlib

        import torch

        def ranged(name, fn):
            def call(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return call

        for _m, mod in per_layer:
            for name, (modname, attr) in getattr(mod, "RANGES", {}).items():
                target = importlib.import_module(modname)
                orig = getattr(target, attr)
                self.restore.append((target, attr, orig))
                setattr(target, attr, ranged(name, orig))
        for name, mod in self.samplers:
            modname, attr = mod.SAMPLE["target"]
            target = importlib.import_module(modname)
            orig = getattr(target, attr)
            self.restore.append((target, attr, orig))
            setattr(target, attr, self._sampled(name, mod, orig))

    def uninstall(self) -> None:
        for target, attr, orig in reversed(self.restore):
            setattr(target, attr, orig)
        self.restore = []

    def _sampled(self, name, mod, orig):
        def call(*a, **k):
            if not self.sampling or len(self.works[name]) >= int(
                    mod.SAMPLE["calls"]):
                return orig(*a, **k)
            _sync(self.device)
            if self.sample_session is None:
                self.sample_session = Profiler(OUT / "trace_sample.json",
                                               self.device, host=False)
            out, work = mod.sample_call(orig, a, k)
            _sync(self.device)
            self.works[name].append(work)
            if all(len(self.works[n]) >= int(m.SAMPLE["calls"])
                   for n, m in self.samplers):
                self.end_sampling()
            return out
        return call

    def end_sampling(self) -> None:
        self.sampling = False
        if self.sample_session is not None:
            self.sample_session.stop()
            self.sample_session = None
        if self.t_on is not None:
            self.held += time.perf_counter() - self.t_on
            self.t_on = None

    # -- the clean window, in the first cluster
    def _start(self) -> None:
        self.t_on = time.perf_counter()
        self.session = Profiler(OUT / "trace_window.json", self.device)

    def _stop(self, rounds: int) -> None:
        _sync(self.device)
        self.session.stop()
        self.session = None
        self.traced_rounds = rounds - int(self.plan["from_round"])
        self.done = True
        self.sampling = bool(self.samplers)
        if not self.sampling:
            self.end_sampling()

    def cluster_start(self, i: int) -> None:
        if i == 0 and int(self.plan["from_round"]) == 0:
            self._start()

    def chunk(self, i: int, rounds: int) -> None:
        if i != 0 or self.done:
            return
        lo = int(self.plan["from_round"])
        if self.session is None and rounds == lo:
            self._start()
        elif self.session is not None and rounds >= lo + int(
                self.plan["rounds"]):
            self._stop(rounds)

    def cluster_end(self, i: int, rounds: int) -> None:
        if i != 0:
            return
        if self.session is not None:
            self._stop(rounds)
        self.end_sampling()


def warm_up(cfg, traffic: dict, seed: int, device) -> None:
    """One throwaway cluster of the cell's shapes, for the mix's warm-up
    rounds."""
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state

    cs = sched.cluster_seed(seed, -1)
    args = sched.run_args(traffic)
    args.update(max_rounds=int(traffic["warm_rounds"]),
                stop_on_convergence=False)
    state = init_state(cfg, seed=cs, device=device)
    run_sim(cfg, state, make_schedule(traffic, cfg.num_nodes), seed=cs,
            device=device, **args)
    del state
    _sync(device)


def run_window(cell, seed: int, seconds: float, device, plan=None):
    """Clusters back to back for ``seconds``; returns the window's record
    and the sampled clusters' outputs."""
    import torch

    from corro_sim_torch.config import SimConfig
    from corro_sim_torch.engine import step as step_mod
    from corro_sim_torch.engine.driver import run_sim
    from corro_sim_torch.engine.state import init_state

    cfg = SimConfig(**cell.config["sim"])
    traffic = cell.traffic
    args = sched.run_args(traffic)
    n = cfg.num_nodes
    converge = traffic["mode"] == "converge"
    judged = set(sched.judged_clusters(seed))
    gates0 = dict(step_mod.SWEEP_GATES)

    def ending(info) -> bool:
        """Whether run_sim returns after this chunk anyway."""
        if info["rounds_done"] >= args["max_rounds"]:
            return True
        return converge and info["gap"] == 0.0 and (
            info["rounds_done"] > args["min_rounds"])

    def peak() -> int:
        return (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)

    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_open = time.perf_counter()
    paused = 0.0  # the judge's copies, outside the window

    def held() -> float:
        return paused + (plan.held if plan is not None else 0.0)

    rounds = 0
    clusters, outputs = [], []
    close = None  # the window's end: when, after how many rounds, the peak
    i = 0
    while close is None:
        cs = sched.cluster_seed(seed, i)
        progress = {"rounds": 0}

        def on_chunk(info, i=i, progress=progress):
            nonlocal close
            progress["rounds"] = info["rounds_done"]
            if plan is not None:
                plan.chunk(i, info["rounds_done"])
                if plan.t_on is not None:
                    return
            now = time.perf_counter()
            if (close is not None or now - held() < t_open + seconds
                    or ending(info)):
                return
            if clusters:
                raise WindowClosed(now)
            # the window's first answer is late: the window ends here,
            # and the cluster runs on to its answer, which is judged
            close = {"at": now, "rounds": rounds + info["rounds_done"],
                     "peak": peak(), "held": held()}

        t0 = time.perf_counter()
        state = init_state(cfg, seed=cs, device=device)
        if plan is not None:
            plan.cluster_start(i)
        try:
            res = run_sim(cfg, state, make_schedule(traffic, n), seed=cs,
                          device=device, on_chunk=on_chunk, **args)
        except WindowClosed as closed:
            rounds += progress["rounds"]
            if plan is not None:
                plan.cluster_end(i, progress["rounds"])
            _sync(device)
            close = {"at": closed.args[0], "rounds": rounds, "peak": peak(),
                     "held": held()}
            break
        finally:
            del state
        t1 = time.perf_counter()
        if plan is not None:
            plan.cluster_end(i, res.rounds)
        rounds += res.rounds
        clusters.append({"seed": cs, "rounds": res.rounds,
                         "converged_round": res.converged_round,
                         "wall_s": t1 - t0, "late": close is not None})
        if i in judged or close is not None:
            _sync(device)
            tp = time.perf_counter()
            outputs.append((i, cs, res.rounds, res.converged_round,
                            host_outputs(res.state)))
            paused += time.perf_counter() - tp
        del res
        i += 1
        now = time.perf_counter()
        if close is None and now - held() >= t_open + seconds:
            close = {"at": now, "rounds": rounds, "peak": peak(),
                     "held": held()}
    gates = {k: step_mod.SWEEP_GATES[k] - gates0[k] for k in gates0}
    win = types.SimpleNamespace(
        wall_s=close["at"] - t_open - close["held"], rounds=close["rounds"],
        clusters=clusters, peak_bytes=close["peak"],
        setup_s=t_open - T_START,
        host_reads=gates["read_on"] + gates["read_off"])
    return win, outputs


def judge_outputs(cell, win, outputs) -> dict:
    """The checks' numbers: each judged cluster against the reference,
    summed, and the clusters the window left without an answer."""
    sim = cell.config["sim"]
    traffic = cell.traffic
    n = int(sim["num_nodes"])
    args = sched.run_args(traffic)
    converge = traffic["mode"] == "converge"
    wr = int(traffic["write_rounds"])
    checks = {name: 0 for name in LIMITS}
    faulty = pinned = judged = 0
    for _i, cs, rounds, conv, out in outputs:
        writes = draws.draw_writes(
            sim, cs, sched.alive_rows(traffic, wr, n), wr, args["chunk"])
        judged += writes["node"].size
        pinned += int(oracle.cv_pinned(writes, num_nodes=n,
                                       num_cols=int(sim["num_cols"]))[0]
                      .sum())
        got = oracle.judge(
            writes, out, num_nodes=n, num_rows=int(sim["num_rows"]),
            num_cols=int(sim["num_cols"]),
            alive_end=sched.alive_row(traffic, max(rounds - 1, 0), n),
            converge=converge)
        got["rounds_wrong"] = oracle.rounds_wrong(
            conv, rounds, chunk=args["chunk"], min_rounds=args["min_rounds"],
            converge=converge, fixed_rounds=args["max_rounds"])
        for k, v in got.items():
            checks[k] += v
        faulty += any(got.values())
    if converge:
        checks["unconverged"] = sum(c["converged_round"] is None
                                    for c in win.clusters)
    checks["none_judged"] = int(not outputs)
    print(f"judged writes: {judged}, col_version fixed by the draws and "
          f"held exactly in {pinned}", file=sys.stderr)
    return checks, faulty


def main(argv=None, device=None, root: Path = cells_mod.ROOT) -> int:
    """Run a cell; returns the exit code. ``device``: run there without
    looking for a card, and ``root``: the checkout whose
    ``BENCHMARK.json`` names the cell (the harness's own tests)."""
    ap = argparse.ArgumentParser(prog="python3 -m simbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    cell = cells_mod.resolve_cell(cells_mod.load_benchmark(root), a.workload,
                               root)
    cache_env()
    import torch

    t_torch = time.perf_counter()
    if device is None:
        device = require_cards(cell.chips)
        if device is None:
            return 2
    t_driver = time.perf_counter()
    import corro_sim_torch.engine.driver  # noqa: F401  (timed here)
    from corro_sim_torch.config import SimConfig
    from corro_sim_torch.core.merge_kernel import build_kernel

    t_import = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.set_device(device)
        build_kernel()
    t_kernel = time.perf_counter()
    cfg = SimConfig(**cell.config["sim"])
    warm_up(cfg, cell.traffic, a.seed, device)
    print(f"setup: torch import {t_torch - T_START:.4f} s, CUDA driver "
          f"{t_driver - t_torch:.4f} s, port import {t_import - t_driver:.4f}"
          f" s, context and kernel {t_kernel - t_import:.4f} s, warm-up "
          f"{time.perf_counter() - t_kernel:.4f} s", file=sys.stderr)

    plan = None
    if a.trace:
        plan = TracePlan(cell, device)
        plan.install(cell.per_layer)
    try:
        win, outputs = run_window(cell, a.seed, a.seconds, device, plan)
    finally:
        if plan is not None:
            plan.end_sampling()
            plan.uninstall()

    bad = forbidden_modules()
    if bad:
        print(f"simbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4

    result = {}
    red = {}
    if a.trace:
        window_file = OUT / "trace_window.json"
        if window_file.exists():
            ranges = [r for _m, mod in cell.per_layer
                      for r in getattr(mod, "RANGES", {})]
            red = trace_mod.reduce_trace(
                trace_mod.load_events(str(window_file)), ranges)
            window_file.unlink()
        sample_file = OUT / "trace_sample.json"
        sample_events = []
        if sample_file.exists():
            sample_events = trace_mod.load_events(str(sample_file))
            sample_file.unlink()
        source = types.SimpleNamespace(
            trace=red or None, traced_rounds=plan.traced_rounds,
            window_rounds=win.rounds,
            counters={"host_reads": win.host_reads},
            sample_work=plan.works,
            sample_kernel_us=lambda frag: trace_mod.kernel_us(
                sample_events, frag))
        readers = cell.per_layer
        if red:
            result["breakdown"] = trace_mod.breakdown(red)
    else:
        source, readers = win, cell.end_to_end
    metrics = {}
    for m, mod in readers:
        v = mod.read(source)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    for i, c in enumerate(win.clusters):
        print(f"cluster {i}: seed {c['seed']}, rounds {c['rounds']}, "
              f"converged at {c['converged_round']}, {c['wall_s']:.4f} s",
              file=sys.stderr)
    print(f"window: {win.wall_s:.4f} s, {win.rounds} rounds, setup "
          f"{win.setup_s:.4f} s", file=sys.stderr)
    t_judge = time.perf_counter()
    checks, faulty = judge_outputs(cell, win, outputs)
    print(f"judge: {len(outputs)} clusters in "
          f"{time.perf_counter() - t_judge:.4f} s", file=sys.stderr)
    correct = all(checks[k] <= LIMITS[k] for k in LIMITS)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(win.peak_bytes)}
    if a.trace:
        dev["busy_s"] = red.get("busy_us", 0.0) / 1e6
        dev["window_s"] = red.get("window_us", 0.0) / 1e6
    line = {"correct": correct, "attempted": len(win.clusters),
            "failed": checks["unconverged"] + faulty, "metrics": metrics,
            "device": dev, **result,
            "checks": {k: {"value": checks[k], "limit": LIMITS[k]}
                       for k in LIMITS}}
    for k in LIMITS:
        print(f"check {k}: {checks[k]} (limit {LIMITS[k]})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
