"""fx audit harness: the vacuity oracle and golden fingerprint of the
port's step, over ``torch.fx`` graphs.

The port's counterpart of ``corro_sim/analysis/jaxpr_audit.py``. The JAX
package traces ``sim_step`` to a jaxpr abstractly; the port's step is
eager PyTorch with host decisions, so here one round of ``sim_step``
(or the repair / workload-driven step) is traced with
``make_fx(torch.func.functionalize(step), tracing_mode="real")`` on the
CPU, seeded, into an SSA graph of aten ops that stands in for a jaxpr:

- **in-place updates** — the step merges into the table planes in
  place; ``functionalize`` turns every write into a functional op, so
  the dataflow passes (:mod:`~corro_sim_torch.analysis.dataflow`) see
  each write (the write-backs to inputs are trailing ``copy_`` nodes);
- **host decisions** — what the host decides from host data (the round
  number's sync and SWIM cadence, ``write_enable``, the keys) is baked
  into the graph, so a graph is the program of the rounds of one
  cadence cycle that together run every block of the step
  (:func:`audit_rounds`; the JAX package traces both arms of every
  ``cond`` in one round). A host read of a tensor's value is the port's
  counterpart of the JAX package's ``device_put`` hazard: ``make_fx``
  refuses to trace it (:class:`HostReadInStep` names it, and the audit
  fails), so a traced program holds no ``aten._local_scalar_dense``
  node; the audit reports the count per program and the golden pins it;
- **the merge kernel** — a ctypes call on the card is invisible to the
  tracer, so the audit traces on the CPU only, where the plain merge
  traces: the audited program is the plain path, and chip_smoke.py holds
  the kernel to that path;
- **the PRNG hash** — ``prng.random_bits`` expands threefry2x32 into
  about a hundred elementwise ops per draw, most of a round's graph; the
  audit traces each draw as one ``corro_audit::threefry_bits`` node
  over its counters (same values, computed by the same function), so
  the graph shows the step's own ops and traces in seconds;
- **op counts depend on torch's version** — the golden
  (``analysis/golden/fx_fingerprint.json``) records the version it was
  written with; a run under another version skips the comparison, as the
  JAX package's does across jax versions.

Node counts are aten-node counts of those rounds; they cannot be
compared with the JAX package's eqn counts of one round.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from collections import Counter

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "golden",
    "fx_fingerprint.json",
)


def audit_config():
    """The canonical fingerprint config (the JAX package's): small fixed
    shapes, SWIM on, sync every 4 rounds."""
    from corro_sim_torch.config import SimConfig

    return SimConfig(
        num_nodes=16, num_rows=16, num_cols=2, log_capacity=64,
        write_rate=0.5, swim_enabled=True, sync_interval=4,
    )


def audit_rounds(cfg) -> list[int]:
    """The rounds the audit traces: over one cadence cycle from round 0
    (the least common multiple of the sync interval and, with SWIM on,
    the SWIM tick and announce intervals), the first round of each set
    of blocks the host's cadence runs (sync sweep, SWIM tick, announce)
    that no other round's set contains. Together they run every block
    of the step; the rounds between run a subset of one of them."""
    import math

    from corro_sim_torch.membership.swim import announce_round, tick_round

    cycle = cfg.sync_interval
    if cfg.swim_enabled:
        cycle = math.lcm(cycle, max(cfg.swim_interval, 1),
                         max(cfg.swim_announce_interval, 1))
    first: dict = {}
    for r in range(cycle):
        tick = cfg.swim_enabled and tick_round(cfg, r)
        sig = frozenset(
            name for name, on in (
                ("sync", r % cfg.sync_interval == cfg.sync_interval - 1),
                ("tick", tick),
                ("announce", tick and announce_round(cfg, r)),
            ) if on)
        first.setdefault(sig, r)
    return sorted(r for sig, r in first.items()
                  if not any(sig < other for other in first))


@dataclasses.dataclass
class Program:
    """One traced program: the graph and the names of its flat inputs and
    outputs, spelled as the JAX package's key paths (``[0].table.cv``
    for a state leaf, ``[1]['gap']`` for a metric)."""

    gm: object  # torch.fx.GraphModule
    in_paths: list
    out_paths: list
    rounds: list  # the host rounds traced, in order

    @property
    def graph(self):
        return self.gm.graph


def _rebuild(template, tensors):
    """``template`` (a state) with its tensor leaves replaced, in
    ``convert._leaves`` order."""
    from corro_sim_torch.engine.state import _map_tensors

    it = iter(tensors)
    return _map_tensors(template, lambda _t: next(it))


def _workload_rows(cfg, seed: int = 0) -> tuple:
    """One round's write-schedule rows ``(writers, rows, cols, vals,
    dels, ncells)`` on the CPU, from a numpy generator or seed: the ON
    side of the workload program."""
    import numpy as np
    import torch

    rng = (seed if isinstance(seed, np.random.Generator)
           else np.random.default_rng(seed))
    n, s = cfg.num_nodes, cfg.seqs_per_version
    return (
        torch.from_numpy(rng.random(n) < 0.5),
        torch.from_numpy(rng.integers(0, cfg.num_rows, (n, s)).astype(
            np.int32)),
        torch.from_numpy(rng.integers(0, cfg.num_cols, (n, s)).astype(
            np.int32)),
        torch.from_numpy(rng.integers(0, 1 << 20, (n, s)).astype(np.int32)),
        torch.from_numpy(rng.random(n) < 0.1),
        torch.from_numpy(np.ones(n, np.int32)),
    )


_BITS_OP: list = []


def _bits_op():
    """The ``corro_audit::threefry_bits`` op: ``prng.threefry2x32``'s
    bits of int64 counters under a key, one graph node per draw."""
    if _BITS_OP:
        return _BITS_OP[0]
    import torch

    from corro_sim_torch import prng

    @torch.library.custom_op("corro_audit::threefry_bits", mutates_args=(),
                             schema="(Tensor lo, int k0, int k1) -> Tensor")
    def threefry_bits(lo, k0, k1):
        b0, b1 = prng.threefry2x32(k0, k1, torch.zeros_like(lo), lo)
        return b0 ^ b1

    @threefry_bits.register_fake
    def _(lo, k0, k1):
        return torch.empty_like(lo)

    _BITS_OP.append(threefry_bits)
    return threefry_bits


@contextlib.contextmanager
def _draws_as_ops():
    """``prng.random_bits`` drawing through :func:`_bits_op` while
    tracing: the same bits, one node per draw."""
    import math

    import torch

    from corro_sim_torch import prng

    op = _bits_op()
    plain = prng.random_bits

    def random_bits(key, shape, device, offset: int = 0):
        shape = tuple(int(d) for d in shape)
        k0, k1 = prng._words(key)
        lo = torch.arange(offset, offset + math.prod(shape),
                          dtype=torch.int64, device=device)
        return op(lo, k0, k1).reshape(shape)

    prng.random_bits = random_bits
    try:
        yield
    finally:
        prng.random_bits = plain


class HostReadInStep(RuntimeError):
    """The traced step reads a tensor's value to the host: the graph
    would depend on the data, and the transfer guard refuses the same
    read on the card."""


def trace(fn, *args, mode: str = "real"):
    """``make_fx(torch.func.functionalize(fn), tracing_mode=mode)`` of
    ``fn`` on ``args``: the fx ``GraphModule``. A host read of a tensor's
    value raises :class:`HostReadInStep`."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        return make_fx(torch.func.functionalize(fn),
                       tracing_mode=mode)(*args)
    except RuntimeError as e:
        if "_local_scalar_dense" not in str(e) and "data-dependent" not in \
                str(e):
            raise
        raise HostReadInStep(
            f"the traced step reads a tensor's value to the host: {e}"
        ) from e


_GRAPHS: dict = {}


def step_graph(cfg, repair: bool = False, workload: bool = False,
               seed: int = 0, mode: str = "real") -> Program:
    """Trace the rounds of :func:`audit_rounds` of ``sim_step`` in turn
    (the repair step with ``repair``, the write-schedule step with
    ``workload``) from ``init_state(cfg, seed)`` on the CPU: round ``r``
    keyed ``fold_in(PRNGKey(seed), r)``, every node up, one partition,
    writes on. Cached by its arguments. The graph's inputs are the
    state's leaves, ``alive``, ``part`` and each round's write rows; its
    outputs the final state's leaves and each metric's per-round series.
    ``mode``: make_fx's
    tracing mode ("fake" runs no arithmetic, for large configs)."""
    key = (cfg, repair, workload and not repair, seed, mode)
    if key not in _GRAPHS:
        _GRAPHS[key] = _trace(cfg, repair, workload, seed, mode)
    return _GRAPHS[key]


def _inputs_mode(mode: str):
    """Where the traced program's inputs are made: under "fake", a
    ``FakeTensorMode`` that make_fx then traces in, so the state's (N, N)
    planes are never allocated; else nowhere special."""
    if mode != "fake":
        return contextlib.nullcontext()
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _trace(cfg, repair, workload, seed, mode) -> Program:
    import numpy as np
    import torch

    from corro_sim_torch import prng
    from corro_sim_torch.convert import _leaves
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.engine.step import sim_step

    rounds = audit_rounds(cfg)
    with _inputs_mode(mode):
        state = init_state(cfg, seed=seed, device="cpu")
        names = [k for k, _ in _leaves(state)]
        flat = [t.clone() for _, t in _leaves(state)]
        n = cfg.num_nodes
        alive = torch.ones((n,), dtype=torch.bool)
        part = torch.zeros((n,), dtype=torch.int32)
        rng = np.random.default_rng(seed)
        writes = ([x for _ in rounds for x in _workload_rows(cfg, rng)]
                  if workload and not repair else [])
    per = len(writes) // len(rounds)
    root = prng.PRNGKey(seed)
    k_state = len(flat)
    metric_names: list = []

    def cycle(*args):
        st = _rebuild(state, args[:k_state])
        a, p = args[k_state], args[k_state + 1]
        w_all = args[k_state + 2:]
        per_round = []
        for i, r in enumerate(rounds):
            w = tuple(w_all[i * per:(i + 1) * per]) or None
            st, m = sim_step(cfg, st, prng.fold_in(root, r), a, p,
                             not repair, r, repair=repair, writes=w,
                             quiesced=False if w else None)
            per_round.append(m)
        metric_names[:] = sorted(per_round[0])
        return (tuple(t for _, t in _leaves(st))
                + tuple(torch.stack([m[k] for m in per_round])
                        for k in metric_names))

    with _draws_as_ops():
        gm = trace(cycle, *flat, alive, part, *writes, mode=mode)
    in_paths = ([f"[0].{k}" for k in names] + ["[2]", "[3]"]
                + [f"[5][{i}]" for i in range(len(writes))])
    out_paths = ([f"[0].{k}" for k in names]
                 + [f"[1]['{k}']" for k in metric_names])
    return Program(gm=gm, in_paths=in_paths, out_paths=out_paths,
                   rounds=list(rounds))


def _op_name(node) -> str:
    return str(node.target)


def op_fingerprint(prog: Program) -> dict:
    """Op-count fingerprint of a graph: total aten nodes + per-op
    counts (the JAX package's ``primitive_fingerprint``)."""
    counts = Counter(_op_name(n) for n in prog.graph.nodes
                     if n.op == "call_function")
    return {
        "eqns": int(sum(counts.values())),
        "primitives": {k: int(v) for k, v in sorted(counts.items())},
    }


def program_text(prog: Program) -> str:
    """Canonical text of the graph — the identity oracle (same nodes,
    same order, same arguments)."""
    return str(prog.gm.code)


def vacuity_matrix(cfg) -> tuple[object, list[tuple[str, object, str]]]:
    """The falsifiable vacuity matrix, the JAX package's: ``pipeline`` is
    host-side dispatch only, so the step graph must be textually
    identical in either position; the probe and fault gates are LIVE (ON
    strictly grows the graph); the all-off graph itself is pinned by the
    golden. Returns ``(off_base_cfg, rows)`` of ``(name, variant_cfg,
    expect)``, expect ``"identical"`` or ``"adds_eqns"``."""
    from corro_sim_torch.config import FaultConfig

    off = dataclasses.replace(
        cfg, probes=0, faults=FaultConfig(), pipeline=True
    )
    return off, [
        ("pipeline_flag",
         dataclasses.replace(off, pipeline=False), "identical"),
        ("probes_gate", dataclasses.replace(off, probes=2), "adds_eqns"),
        ("faults_gate",
         dataclasses.replace(off, faults=FaultConfig(trace_vacuous=True)),
         "adds_eqns"),
    ]


def extra_eqns(cfg_base, cfg_other, repair: bool = False,
               workload_other: bool = False) -> int:
    """Node-count delta of ``cfg_other``'s step graph over the base's.
    ``workload_other`` traces the other side's write-schedule step."""
    a = op_fingerprint(step_graph(cfg_base, repair=repair))
    b = op_fingerprint(
        step_graph(cfg_other, repair=repair, workload=workload_other)
    )
    return b["eqns"] - a["eqns"]


def assert_same_program(cfg_a, cfg_b, repair: bool = False,
                        label: str = "") -> None:
    """Identical-program assertion: the graphs' code must be equal, node
    for node. Raises AssertionError with the per-op diff otherwise."""
    ja = step_graph(cfg_a, repair=repair)
    jb = step_graph(cfg_b, repair=repair)
    if program_text(ja) == program_text(jb):
        return
    fa, fb = op_fingerprint(ja), op_fingerprint(jb)
    diff = {
        op: (fa["primitives"].get(op, 0), fb["primitives"].get(op, 0))
        for op in set(fa["primitives"]) | set(fb["primitives"])
        if fa["primitives"].get(op, 0) != fb["primitives"].get(op, 0)
    }
    raise AssertionError(
        f"step programs differ{f' ({label})' if label else ''}: "
        f"{fa['eqns']} vs {fb['eqns']} nodes; op diff "
        f"(base, variant): {diff or 'same counts, different structure'}"
    )


def step_metric_names(cfg) -> set[str]:
    """Metric keys the step emits: one round run on the CPU (every round
    emits the same keys)."""
    import torch

    from corro_sim_torch import prng
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.engine.step import sim_step

    n = cfg.num_nodes
    _, m = sim_step(cfg, init_state(cfg, seed=0, device="cpu"),
                    prng.PRNGKey(0), torch.ones((n,), dtype=torch.bool),
                    torch.zeros((n,), dtype=torch.int32), True, 0)
    return set(m)


def run_step_loop(cfg, rounds: int, write_rounds: int, seed: int,
                  init_seed: int = 0, part=None, workload=None):
    """The plain step loop the runtime vacuity oracle replays, on the
    CPU: round ``r`` keyed ``fold_in(PRNGKey(seed), r)``. ``workload``:
    a compiled :class:`~corro_sim_torch.workload.generators.Workload`
    whose rows feed ``sim_step``'s ``writes=`` port. Returns ``(state
    leaves as numpy, per-round metric dicts of numpy)``."""
    import numpy as np
    import torch

    from corro_sim_torch import prng
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.engine.step import sim_step

    state = init_state(cfg, seed=init_seed, device="cpu")
    alive = torch.ones((cfg.num_nodes,), dtype=torch.bool)
    part = torch.from_numpy(np.ascontiguousarray(
        part if part is not None
        else np.zeros(cfg.num_nodes, np.int32), dtype=np.int32))
    root = prng.PRNGKey(seed)
    metrics = []
    for r in range(rounds):
        writes = None
        if workload is not None:
            writes = tuple(
                torch.from_numpy(np.ascontiguousarray(x))
                for x in workload.writes_at(r, cfg.seqs_per_version)
            )
        state, m = sim_step(cfg, state, prng.fold_in(root, r), alive, part,
                            r < write_rounds, r, writes=writes)
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    return state_to_numpy(state), metrics


def assert_feature_vacuous(base_cfg, on_cfg, *, exclude_leaves=(),
                           extra_metrics=frozenset(),
                           zero_metrics=(), rounds: int = 16,
                           write_rounds: int = 4, seed: int = 3,
                           part=None, on_workload=None) -> None:
    """THE vacuity oracle, the JAX package's:

    - trace level — the feature changes the step graph (``extra_eqns >
      0``; with ``on_workload`` the write-schedule graph is a different
      graph, either direction);
    - runtime level — the feature-ON run equals the base run on every
      state leaf except ``exclude_leaves`` (top-level field names) and
      on every shared metric; its metric surface grows by exactly
      ``extra_metrics``, and ``zero_metrics`` stay zero throughout.

    Raised, not asserted: the check must hold under ``python -O``."""
    import numpy as np

    delta = extra_eqns(base_cfg, on_cfg,
                       workload_other=on_workload is not None)
    if on_workload is not None:
        if delta == 0:
            raise AssertionError(
                "workload program traces identical to the sampler "
                "program — the writes port is not a distinct program")
    elif delta <= 0:
        raise AssertionError(
            "feature-ON config traces the same program as the base — the "
            "static gate is not gating anything")
    s0, m0 = run_step_loop(base_cfg, rounds, write_rounds, seed, part=part)
    s1, m1 = run_step_loop(on_cfg, rounds, write_rounds, seed, part=part,
                           workload=on_workload)
    for k in s0:
        if k.split(".")[0].split("[")[0] in exclude_leaves:
            continue
        if k not in s1 or not np.array_equal(s0[k], s1[k]):
            raise AssertionError(f"state leaf {k} differs")
    for r, (a, b) in enumerate(zip(m0, m1)):
        for k in a:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"metric {k} differs at round {r}")
    if set(m1[0]) - set(m0[0]) != set(extra_metrics):
        raise AssertionError("feature metrics are not additive-only")
    for m in m1:
        for k in zero_metrics:
            if int(m[k]) != 0:
                raise AssertionError(f"{k} = {int(m[k])}, not zero")


def audit(cfg=None) -> dict:
    """The full audit: vacuity matrix + host reads + fingerprints.
    Returns a JSON-ready report; callers read ``report["ok"]`` /
    ``report["problems"]``."""
    import torch

    if cfg is None:
        cfg = audit_config()
    problems: list[str] = []
    full = step_graph(cfg)
    repair = step_graph(cfg, repair=True)
    programs = {"full": op_fingerprint(full),
                "repair": op_fingerprint(repair)}

    off_cfg, rows = vacuity_matrix(cfg)
    off = step_graph(off_cfg) if off_cfg != cfg else full
    off_text = program_text(off)
    off_eqns = op_fingerprint(off)["eqns"]
    vacuity = []
    for name, variant, expect in rows:
        v = step_graph(variant)
        identical = program_text(v) == off_text
        delta = op_fingerprint(v)["eqns"] - off_eqns
        ok = identical if expect == "identical" else (
            not identical and delta > 0
        )
        vacuity.append({"variant": name, "identical": identical,
                        "extra_eqns": delta, "expect": expect, "ok": ok})
        if not ok:
            problems.append(
                f"vacuity violated: '{name}' expected "
                + ("an identical step program but it differs "
                   if expect == "identical" else
                   "the feature to grow the program (live gate) but it "
                   "did not ")
                + f"({delta:+d} nodes)"
            )

    from corro_sim_torch.analysis.dataflow import host_read_eqns

    hazards = {}
    for prog_name, prog in (("full", full), ("repair", repair)):
        fp = programs[prog_name]
        hazards[prog_name] = {
            "host_reads": len(host_read_eqns(prog)),
            "dtype_casts": fp["primitives"].get("aten._to_copy.default", 0),
        }

    return {
        "torch_version": torch.__version__,
        "config": {
            "num_nodes": cfg.num_nodes, "num_rows": cfg.num_rows,
            "num_cols": cfg.num_cols, "log_capacity": cfg.log_capacity,
            "swim_enabled": cfg.swim_enabled,
            "sync_interval": cfg.sync_interval,
            "rounds": full.rounds,
        },
        "programs": programs,
        "vacuity": vacuity,
        "hazards": hazards,
        "problems": problems,
        "ok": not problems,
    }


def run_audit(update_golden: bool = False, out: str | None = None,
              as_json: bool = False, diff: bool = False,
              contracts: bool = False, keys: bool = False) -> int:
    """The `audit` entry point: trace, audit, check (or rewrite) the
    golden fingerprint; returns the exit code (1 on any vacuity problem
    or golden drift). ``diff`` adds the per-op delta vs the golden.
    ``contracts``/``keys`` also run the program-contract and key-lineage
    auditors against their own goldens (re-baselined with
    ``update_golden``)."""
    report = audit()
    if update_golden:
        write_golden(report)
        report["golden_updated"] = GOLDEN_PATH
        drift: list[str] = []
    else:
        golden = load_golden()
        if (golden is not None
                and golden.get("torch_version") != report["torch_version"]):
            # op counts legitimately shift between torch releases
            report["golden_skipped"] = (
                f"golden written under torch {golden.get('torch_version')}"
                f", running {report['torch_version']} — comparison "
                "skipped"
            )
            drift = []
        else:
            drift = check_golden(report)
    report["golden_drift"] = drift
    report["ok"] = report["ok"] and not drift
    if diff:
        report["golden_diff"] = golden_diff(report)
    if contracts:
        from corro_sim_torch.analysis import contracts as _contracts

        if update_golden:
            crep = _contracts.build_report()
            _contracts.write_golden(crep)
            crep["golden_updated"] = _contracts.GOLDEN_PATH
            crep = _contracts.check(crep)
        else:
            crep = _contracts.check()
        report["contracts"] = crep
        report["ok"] = report["ok"] and crep["ok"]
    if keys:
        from corro_sim_torch.analysis import keys as _keys

        if update_golden:
            krep = _keys.build_report()
            _keys.write_golden(krep)
            krep["golden_updated"] = _keys.GOLDEN_PATH
            krep = _keys.check(krep)
        else:
            krep = _keys.check()
        report["keys"] = krep
        report["ok"] = report["ok"] and krep["ok"]
    if as_json:
        print(json.dumps(report, indent=2))
    else:
        for line in render_text(report, diff=diff):
            print(line)
    if out:
        with open(out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
    return 0 if report["ok"] else 1


def render_text(report: dict, diff: bool = False) -> list[str]:
    """The audit's text report (the CLI's non-JSON output)."""
    lines = []
    for v in report["vacuity"]:
        mark = "ok" if v["ok"] else "VIOLATED"
        lines.append(f"vacuity  {v['variant']:<14} {mark} "
                     f"[{v['expect']}] ({v['extra_eqns']:+d} nodes)")
    for prog, hz in report["hazards"].items():
        lines.append(f"hazards  {prog:<14} host_reads={hz['host_reads']} "
                     f"dtype_casts={hz['dtype_casts']}")
    for prog, fp in report["programs"].items():
        lines.append(f"program  {prog:<14} {fp['eqns']} aten nodes, "
                     f"{len(fp['primitives'])} distinct ops")
    if diff:
        gd = report.get("golden_diff")
        if gd is None:
            lines.append("diff     (no golden committed — nothing to diff)")
        else:
            for prog, d in gd.items():
                if d is None:
                    lines.append(f"diff     {prog:<14} (not in golden)")
                    continue
                lines.append(
                    f"diff     {prog:<14} {d['eqns']} nodes vs golden "
                    f"{d['golden_eqns']} ({d['delta_eqns']:+d})")
                for op, delta in sorted(d["primitives"].items(),
                                        key=lambda kv: (-abs(kv[1]),
                                                        kv[0])):
                    lines.append(f"diff       {op:<32} {delta:+d}")
    if "contracts" in report:
        from corro_sim_torch.analysis import contracts as _contracts

        lines += _contracts.render_text(report["contracts"])
    if "keys" in report:
        from corro_sim_torch.analysis import keys as _keys

        lines += _keys.render_text(report["keys"])
    for p in report["problems"] + report.get("golden_drift", []):
        lines.append(f"PROBLEM  {p}")
    if report.get("golden_skipped"):
        lines.append(f"golden   skipped: {report['golden_skipped']}")
    for key in ("golden_updated",):
        for rep in (report, report.get("contracts") or {},
                    report.get("keys") or {}):
            if rep.get(key):
                lines.append(f"golden   updated: {rep[key]}")
    lines.append("audit: " + ("ok" if report["ok"] else "FAILED"))
    return lines


def golden_diff(report: dict, path: str | None = None) -> dict | None:
    """Per-op node delta of the report's programs vs the committed
    golden (``audit --diff``); None when no golden exists."""
    golden = load_golden(path or GOLDEN_PATH)
    if golden is None:
        return None
    out: dict = {}
    for prog, fp in report["programs"].items():
        gold = golden.get("programs", {}).get(prog)
        if gold is None:
            out[prog] = None
            continue
        ops = set(fp["primitives"]) | set(gold["primitives"])
        deltas = {
            p: fp["primitives"].get(p, 0) - gold["primitives"].get(p, 0)
            for p in sorted(ops)
        }
        out[prog] = {
            "golden_eqns": gold["eqns"],
            "eqns": fp["eqns"],
            "delta_eqns": fp["eqns"] - gold["eqns"],
            "primitives": {p: d for p, d in deltas.items() if d},
        }
    return out


def load_golden(path: str | None = None) -> dict | None:
    try:
        with open(path or GOLDEN_PATH, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def write_golden(report: dict, path: str | None = None) -> None:
    path = path or GOLDEN_PATH
    os.makedirs(os.path.dirname(path), exist_ok=True)
    golden = {
        "torch_version": report["torch_version"],
        "config": report["config"],
        "programs": report["programs"],
        "hazards": report["hazards"],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(golden, fh, indent=2, sort_keys=True)
        fh.write("\n")


def check_golden(report: dict, path: str | None = None) -> list[str]:
    """Compare the report's fingerprints against the committed golden;
    returns drift problems (empty = clean)."""
    path = path or GOLDEN_PATH
    golden = load_golden(path)
    if golden is None:
        return [
            f"no golden fingerprint at {path} — run "
            "`python -m corro_sim_torch audit --update-golden` and commit "
            "the file"
        ]
    problems: list[str] = []
    for prog, fp in report["programs"].items():
        gold = golden.get("programs", {}).get(prog)
        if gold is None:
            problems.append(f"golden has no '{prog}' program fingerprint")
            continue
        if fp == gold:
            continue
        drift = {
            op: (gold["primitives"].get(op, 0), fp["primitives"].get(op, 0))
            for op in set(gold["primitives"]) | set(fp["primitives"])
            if gold["primitives"].get(op, 0) != fp["primitives"].get(op, 0)
        }
        problems.append(
            f"op-count drift in '{prog}': {gold['eqns']} -> "
            f"{fp['eqns']} nodes; per-op (golden, now): {drift}"
        )
    return problems
