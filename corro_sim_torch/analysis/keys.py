"""Key-lineage auditor: proofs that every PRNG stream of the port's step
is disjoint (``audit --keys``).

The port's counterpart of ``corro_sim/analysis/keys.py``. The JAX
package walks each traced program's jaxpr from its key input through
``random_fold_in`` / ``random_split`` to every ``random_bits`` draw. The
port's keys are host numpy arrays derived in ``prng.py`` (the counters
of its draws are the only device part), so no graph shows their lineage.
This module records it instead: while a program runs on the CPU at the
audit configs, :func:`recording` wraps ``prng.py``'s ``split``,
``fold_in``, ``random_bits`` and ``PRNGKey`` (the samplers ``uniform``,
``randint``, ``permutation`` and ``choice`` derive and draw through
them) and the step's entry, and notes for every call the parent key's
address, the derivation and the draw site. Each step round is one
scope: its key is the root.

Address grammar (the JAX package's; golden-pinned per program in
``analysis/golden/key_lineage.json``)::

    key                      the round's key (``keys[r]`` where the
                             program is a chunk of rounds)
    A/fold(T)                fold_in(A, T); T the literal tag, or ``?ci``
                             / ``?r`` for a chunk index / round number
    A/splitK[i]              child i of split(A, K)

Three contract families, proven per program:

- **K1 single-consumption** — every address feeds at most one draw or
  split (fold_in is derivation, not consumption). Draws of disjoint
  counter ranges of one key (``random_bits(..., offset=)``, a mesh
  rank's rows of a global draw) are one draw.
- **K2 stream disjointness** — under any one parent key, fold tags are
  pairwise distinct, and every observed tag is a DECLARED constant next
  to its draw site (:func:`declared_tags`), with the SWIM announce tag
  outside the per-config peer-tag range.
- **K3 lane/fork independence** — every engine derives its round keys
  through the shared helpers (``engine/driver.py chunk_keys /
  round_key``): module aliasing + call-site checks pin the indirection,
  the helpers' derivation chains are pinned, and a recorded sweep shows
  each lane's round keys equal its serial twin's (the driver's
  ``chunk_keys(PRNGKey(seed), ci)``) and lanes of distinct seeds share no
  key. Twin forecasts race forks as sweep lanes, through the same path.

Re-baseline with ``audit --keys --update-golden``. Golden comparison is
keyed by torch version; the BUDGET asserts (K1/K2/K3 proven) run
everywhere.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import re
from collections import Counter

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "golden",
    "key_lineage.json",
)

KEY_FAMILIES = {
    "step": "single-device step rounds (lineage proven on the "
            "audit/smoke representatives and the chunk runner)",
    "sweep": "fleet-of-clusters lanes (each lane's round keys are its "
             "serial twin's chunk_keys)",
    "sharded_step": "mesh-sharded rounds (same forest as the chunk "
                    "runner, sharding is lineage-invariant)",
}

# K3 prologue chains: what chunk_keys/round_key must record (the JAX
# package's pins)
CHUNK_PROLOGUE = {"folds": {"key": ["?ci"]},
                  "splits": ["key/fold(?ci)/split8"]}
ROUND_PROLOGUE = {"folds": {"key": ["?r"]}, "splits": []}


class Label(int):
    """An int that names itself in a recorded fold tag (``?ci``, ``?r``):
    the prologue chains fold a chunk index or round number, not a
    constant."""

    def __new__(cls, value: int, name: str):
        obj = super().__new__(cls, value)
        obj.name = name
        return obj


def declared_tags() -> dict[str, int]:
    """The named stream-tag constants declared next to their draw sites:
    the registry side of K2's declared == observed check."""
    from corro_sim_torch.faults.inject import FAULT_KEY_TAG
    from corro_sim_torch.gossip.broadcast import BROADCAST_TARGET_KEY_TAG
    from corro_sim_torch.membership.swim import (
        SWIM_ANNOUNCE_KEY_TAG,
        SWIM_PEER_KEY_TAG_BASE,
    )

    return {
        "broadcast_targets": int(BROADCAST_TARGET_KEY_TAG),
        "fault_lane": int(FAULT_KEY_TAG),
        "swim_announce": int(SWIM_ANNOUNCE_KEY_TAG),
        "swim_peer_base": int(SWIM_PEER_KEY_TAG_BASE),
    }


def expected_tags(cfg=None) -> dict[int, str]:
    """tag value -> stream name, for one config: the declared constants
    plus the SWIM peer-exchange range ``[base, base +
    swim_gossip_peers)``."""
    decl = declared_tags()
    tags = {
        decl["fault_lane"]: "fault_lane",
        decl["broadcast_targets"]: "broadcast_targets",
        decl["swim_announce"]: "swim_announce",
    }
    peers = int(getattr(cfg, "swim_gossip_peers", 0) or 0) if cfg else 0
    for g in range(peers):
        tags.setdefault(decl["swim_peer_base"] + g, f"swim_peer[{g}]")
    return tags


# ------------------------------------------------------------ recorder

class _Rec:
    """One scope's facts (a step round, or a prologue)."""

    __slots__ = ("draws", "folds", "splits", "consumers", "notes")

    def __init__(self):
        self.draws: list[tuple[str, str]] = []
        self.folds: list[tuple[str, str, str]] = []  # (parent, tag, site)
        self.splits: list[str] = []
        # (addr, kind, counter range or None)
        self.consumers: list[tuple[str, str, tuple | None]] = []
        self.notes: Counter = Counter()


class Recorder:
    """Key lineage of everything ``prng.py`` derives and draws while
    :func:`recording` is active, one :class:`_Rec` per scope."""

    def __init__(self, root_name: str = "key", steps_only: bool = True):
        self.root_name = root_name
        self.steps_only = steps_only
        self.in_step = 0
        self.outside = _Rec()  # derivations outside a step round
        self.scopes: list[_Rec] = []
        self.addr: dict[bytes, str] = {}
        self.roots: dict[bytes, str] = {}  # PRNGKey outputs -> "seed(s)"

    @property
    def rec(self) -> _Rec:
        if self.steps_only and not self.in_step:
            return self.outside
        if not self.scopes:
            self.new_scope()
        return self.scopes[-1]

    def new_scope(self, root=None, name: str | None = None) -> None:
        self.scopes.append(_Rec())
        self.addr = dict(self.roots)
        if root is not None:
            self.addr[_kb(root)] = name or self.root_name

    def lookup(self, key) -> str | None:
        return self.addr.get(_kb(key))


def _kb(key) -> bytes:
    import numpy as np

    return np.asarray(key, dtype=np.uint32).tobytes()


def _site() -> str:
    """The first caller outside prng.py and this module, as
    ``package/module.py:line``."""
    import sys

    fr = sys._getframe(2)
    while fr is not None:
        f = fr.f_code.co_filename.replace("\\", "/")
        if not f.endswith(("/prng.py", "/analysis/keys.py")):
            return "/".join(f.rsplit("/", 2)[-2:]) + f":{fr.f_lineno}"
        fr = fr.f_back
    return "?"


@contextlib.contextmanager
def recording(root_name: str = "key", steps_only: bool = True):
    """Record key lineage: ``prng.py``'s derivations and draws, and a new
    scope at every step round (``engine/step.py``'s ``_step``), whose
    key is the scope's root ``root_name``. ``steps_only``: what happens
    outside a step round (an engine's key prologue) goes to
    ``Recorder.outside``, not to the program's scopes. Yields the
    :class:`Recorder`."""
    import numpy as np

    from corro_sim_torch import prng
    from corro_sim_torch.engine import step as step_mod

    r = Recorder(root_name, steps_only)
    plain = {k: getattr(prng, k) for k in ("PRNGKey", "split", "fold_in",
                                           "random_bits")}
    plain_step = step_mod._step

    def PRNGKey(seed):
        out = plain["PRNGKey"](seed)
        r.roots[_kb(out)] = f"seed({int(seed)})"
        r.addr[_kb(out)] = f"seed({int(seed)})"
        return out

    def split(key, num: int = 2):
        out = plain["split"](key, num)
        parent = r.lookup(key)
        if parent is None:
            r.rec.notes["unknown_split_parent"] += 1
            return out
        addr = f"{parent}/split{int(num)}"
        r.rec.consumers.append((parent, "split", None))
        r.rec.splits.append(addr)
        for i in range(int(num)):
            r.addr[_kb(out[i])] = f"{addr}[{i}]"
        return out

    def fold_in(key, data):
        out = plain["fold_in"](key, data)
        parent = r.lookup(key)
        tag = (f"?{data.name}" if isinstance(data, Label)
               else str(int(data)))
        if parent is None:
            r.rec.notes["unknown_fold_parent"] += 1
            return out
        r.rec.folds.append((parent, tag, _site()))
        r.addr[_kb(out)] = f"{parent}/fold({tag})"
        return out

    def random_bits(key, shape, device, offset: int = 0):
        out = plain["random_bits"](key, shape, device, offset)
        shape_s = "x".join(str(int(d)) for d in shape) or "()"
        parent = r.lookup(key)
        if parent is None:
            r.rec.notes["anonymous_draws"] += 1
            r.rec.draws.append(("anon", shape_s))
            return out
        size = int(np.prod([int(d) for d in shape])) if shape else 1
        r.rec.consumers.append((parent, "bits",
                                (int(offset), int(offset) + size)))
        r.rec.draws.append((parent, shape_s))
        return out

    def _step(cfg, state, key, *rest):
        r.new_scope(key)
        r.in_step += 1
        try:
            return plain_step(cfg, state, key, *rest)
        finally:
            r.in_step -= 1

    for k, fn in (("PRNGKey", PRNGKey), ("split", split),
                  ("fold_in", fold_in), ("random_bits", random_bits)):
        setattr(prng, k, fn)
    step_mod._step = _step
    try:
        yield r
    finally:
        for k, fn in plain.items():
            setattr(prng, k, fn)
        step_mod._step = plain_step


# ----------------------------------------------------- contract checks

def _k1(rec: _Rec) -> dict:
    by_addr: dict[str, list] = {}
    for addr, kind, rng in rec.consumers:
        by_addr.setdefault(addr, []).append((kind, rng))
    violations = []
    for addr in sorted(by_addr):
        uses = by_addr[addr]
        if len(uses) < 2:
            continue
        # disjoint counter ranges of one key are one draw
        clash = any(k != "bits" for k, _ in uses)
        if not clash:
            spans = sorted(rng for _, rng in uses)
            clash = any(a[1] > b[0] for a, b in zip(spans, spans[1:]))
        if clash:
            violations.append(
                f"K1: key '{addr}' consumed {len(uses)} times "
                f"({', '.join(sorted(k for k, _ in uses))}) — "
                "derive a child per draw instead of reusing the key"
            )
    return {
        "status": "proven" if not violations else "violated",
        "keys_checked": len(by_addr),
        "violations": violations,
    }


def _k2(rec: _Rec, cfg) -> dict:
    decl = declared_tags()
    by_parent: dict[str, dict] = {}
    for parent, tag, site in rec.folds:
        by_parent.setdefault(parent, {}).setdefault(tag, []).append(site)
    expected = expected_tags(cfg)
    violations = []
    for parent in sorted(by_parent):
        tags = by_parent[parent]
        for tag in sorted(tags):
            sites = tags[tag]
            if len(sites) > 1:
                violations.append(
                    f"K2: tag collision under '{parent}': fold({tag}) "
                    f"at {len(sites)} sites ({', '.join(sites)}) folds the "
                    "same stream twice"
                )
            if tag.startswith("?"):
                if len(tags) > 1:
                    violations.append(
                        f"K2: traced tag fold({tag}) under '{parent}' "
                        f"is ambiguous against sibling tags "
                        f"{sorted(t for t in tags if t != tag)}"
                    )
            elif cfg is not None and int(tag) not in expected:
                violations.append(
                    f"K2: undeclared stream tag fold({tag}) under "
                    f"'{parent}' — declare a named constant next to "
                    "the draw site and re-baseline"
                )
    peers = int(getattr(cfg, "swim_gossip_peers", 0) or 0) if cfg else 0
    base, announce = decl["swim_peer_base"], decl["swim_announce"]
    if peers and base <= announce < base + peers:
        violations.append(
            f"K2: SWIM announce tag {announce} falls inside the "
            f"peer-exchange tag range [{base}, {base + peers}) — the "
            "announce stream would collide with a peer stream"
        )
    return {
        "status": "proven" if not violations else "violated",
        "parents_checked": len(by_parent),
        "tags_checked": sum(len(t) for t in by_parent.values()),
        "violations": violations,
        "fold_tags": {p: sorted(by_parent[p]) for p in sorted(by_parent)},
    }


def analyze_records(scopes: list, cfg=None) -> dict:
    """K1/K2 over each scope, and the program's derivation forest: the
    union of its scopes' roots, draws, splits and fold tags."""
    draws: dict[str, set] = {}
    splits: set = set()
    fold_tags: dict[str, set] = {}
    notes: Counter = Counter()
    k1 = {"status": "proven", "keys_checked": 0, "violations": []}
    k2 = {"status": "proven", "parents_checked": 0, "tags_checked": 0,
          "violations": []}
    roots: set = set()
    for rec in scopes:
        for addr, shape in rec.draws:
            draws.setdefault(addr, set()).add(shape)
        splits |= set(rec.splits)
        notes.update(rec.notes)
        a, b = _k1(rec), _k2(rec, cfg)
        for parent, tags in b.pop("fold_tags").items():
            fold_tags.setdefault(parent, set()).update(tags)
        k1["keys_checked"] += a["keys_checked"]
        k2["parents_checked"] += b["parents_checked"]
        k2["tags_checked"] += b["tags_checked"]
        for d, s in ((k1, a), (k2, b)):
            for v in s["violations"]:
                if v not in d["violations"]:
                    d["violations"].append(v)
        used = ({x for x, _ in rec.draws} | {p for p, _, _ in rec.folds}
                | {p for p, _, _ in rec.consumers})
        # a root is its input's name: ``keys`` for the ``keys[r]`` rows
        roots |= {re.split(r"[/\[]", u, maxsplit=1)[0] for u in used
                  if u != "anon"}
    for d in (k1, k2):
        d["status"] = "proven" if not d["violations"] else "violated"
    return {
        "roots": sorted(roots),
        "draws": {a: sorted(draws[a]) for a in sorted(draws)},
        "splits": sorted(splits),
        "fold_tags": {p: sorted(fold_tags[p]) for p in sorted(fold_tags)},
        "k1": k1,
        "k2": k2,
        "notes": {k: notes[k] for k in sorted(notes)},
    }


# ------------------------------------------------------ program matrix

def _step_entry(cfg, repair: bool = False, workload: bool = False):
    """The audit rounds (``fx_audit.audit_rounds``) of one step program,
    run on the CPU under the recorder: each round's key is ``key``."""
    import torch

    from corro_sim_torch import prng
    from corro_sim_torch.analysis.fx_audit import (
        _workload_rows,
        audit_rounds,
    )
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.engine.step import sim_step

    n = cfg.num_nodes
    alive = torch.ones((n,), dtype=torch.bool)
    part = torch.zeros((n,), dtype=torch.int32)
    state = init_state(cfg, seed=0, device="cpu")
    root = prng.PRNGKey(0)
    keys = {r: prng.fold_in(root, r) for r in audit_rounds(cfg)}
    with recording("key") as rec:
        for r, key in keys.items():
            w = _workload_rows(cfg, r) if workload and not repair else None
            state, _ = sim_step(cfg, state, key, alive, part, not repair, r,
                                repair=repair, writes=w,
                                quiesced=False if w else None)
    return analyze_records(rec.scopes, cfg=cfg)


def _chunk_entry(cfg, chunk: int = 8):
    """One chunk of the driver's chunk runner (``_chunk_runner``) on the
    CPU: each round's key is ``keys[r]``."""
    import numpy as np

    from corro_sim_torch.engine.driver import (
        Schedule,
        _chunk_runner,
        chunk_keys,
    )
    from corro_sim_torch import prng
    from corro_sim_torch.engine.state import init_state

    alive, part, we = Schedule(write_rounds=chunk).slice(0, chunk,
                                                        cfg.num_nodes)
    keys = chunk_keys(prng.PRNGKey(0), 0, chunk)
    run = _chunk_runner(cfg, device="cpu")
    with recording("keys[r]") as rec:
        run(init_state(cfg, seed=0, device="cpu"), keys, alive, part,
            np.asarray(we))
    return analyze_records(rec.scopes, cfg=cfg)


def _sweep_plan():
    """The JAX package's representative sweep: 16 nodes, 32 rows, lossy
    and clock-skew lanes over seeds 0-3."""
    from corro_sim_torch.config import SimConfig
    from corro_sim_torch.sweep.plan import build_plan

    base = SimConfig(num_nodes=16, num_rows=32).validate()
    return build_plan(base, ["lossy:p=0.1", "clock_skew"], [0, 1, 2, 3],
                      rounds=32, write_rounds=8)


def _sweep_records(chunk: int = 8):
    """One chunk of every lane of :func:`_sweep_plan` through
    ``run_sweep`` on the CPU, under the recorder (each round's key is
    ``keys[r]``), and each lane's recorded round keys."""
    from corro_sim_torch.sweep.engine import run_sweep

    plan = _sweep_plan()
    with recording("keys[r]") as rec:
        lane_keys: list = []
        from corro_sim_torch.engine import step as step_mod

        inner = step_mod._step

        def keyed(cfg, state, key, *rest):
            lane_keys.append(_kb(key))
            return inner(cfg, state, key, *rest)

        step_mod._step = keyed
        try:
            run_sweep(plan, max_rounds=chunk, chunk=chunk, device="cpu",
                      scorecards=False)
        finally:
            step_mod._step = inner
    return plan, rec, lane_keys


def _sweep_entry():
    plan, rec, _ = _sweep_records()
    return analyze_records(rec.scopes, cfg=plan.union_cfg)


def sharded_job(cfg, rounds: int) -> dict:
    """On every rank: ``rounds`` sharded step rounds of ``cfg`` under the
    recorder (each round's key ``keys[r]``); rank 0's analysis comes
    back."""
    import torch

    from corro_sim_torch import prng
    from corro_sim_torch.engine.sharding import make_mesh
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.engine.step import sim_step

    mesh = make_mesh()
    state = init_state(cfg, seed=0, mesh=mesh, device=mesh.device)
    n = cfg.num_nodes
    alive = torch.ones((n,), dtype=torch.bool, device=mesh.device)
    part = torch.zeros((n,), dtype=torch.int32, device=mesh.device)
    keys = [prng.fold_in(prng.PRNGKey(0), r) for r in range(rounds)]
    with recording("keys[r]") as rec:
        for r in range(rounds):
            state, _ = sim_step(cfg, state, keys[r], alive, part, True, r,
                                mesh=mesh)
    return analyze_records(rec.scopes, cfg=cfg)


def _sharded_entry(ranks: int = 2):
    from corro_sim_torch.analysis.contracts import census_config
    from corro_sim_torch.analysis.fx_audit import audit_rounds
    from corro_sim_torch.engine.ranks import run_ranks

    cfg = census_config()
    return run_ranks(sharded_job, ranks, cfg, max(audit_rounds(cfg)) + 1,
                     device="cpu")


def key_programs() -> dict[str, tuple[str, object]]:
    """name -> (family, thunk): the representative program matrix the
    manifest pins (the JAX package's)."""
    import dataclasses

    from corro_sim_torch.analysis.contracts import smoke_config
    from corro_sim_torch.analysis.fx_audit import audit_config
    from corro_sim_torch.config import FaultConfig

    audit_cfg = audit_config()
    fault_cfg = dataclasses.replace(
        audit_cfg, faults=FaultConfig(loss=0.1, burst_enter=0.05)
    )
    smoke = smoke_config()
    return {
        "audit/full": ("step", lambda: _step_entry(audit_cfg)),
        "audit/repair": (
            "step", lambda: _step_entry(audit_cfg, repair=True)),
        "audit/workload": (
            "step", lambda: _step_entry(audit_cfg, workload=True)),
        "audit/faults": ("step", lambda: _step_entry(fault_cfg)),
        "smoke/full": ("step", lambda: _step_entry(smoke)),
        "smoke/repair": (
            "step", lambda: _step_entry(smoke, repair=True)),
        "chunk/full": ("step", lambda: _chunk_entry(audit_cfg)),
        "sweep/lanes": ("sweep", _sweep_entry),
        "sharded/full": ("sharded_step", _sharded_entry),
    }


# ------------------------------------------------------- K3 prologues

def _prologue_chain(fn, label: str) -> dict:
    """Record a host-side derivation helper over a root named ``key``
    with its index labeled, and linearize its fold/split chain."""
    import numpy as np

    root = np.array([0, 42], np.uint32)
    with recording("key", steps_only=False) as rec:
        rec.new_scope(root)
        fn(root, Label(3, label))
    rep = analyze_records(rec.scopes)
    return {"folds": rep["fold_tags"], "splits": rep["splits"]}


def _lane_report() -> dict:
    """The recorded sweep's lanes: each lane's round keys equal its
    serial twin's (``chunk_keys(PRNGKey(seed), ci)``), and lanes of
    distinct seeds share no key."""
    from corro_sim_torch import prng
    from corro_sim_torch.engine.driver import chunk_keys

    plan, _, lane_keys = _sweep_records()
    chunk = 8
    want = {int(lane.seed): [_kb(k) for k in chunk_keys(
        prng.PRNGKey(lane.seed), 0, chunk)] for lane in plan.lanes}
    # every lane drew exactly its serial twin's keys: the recorded round
    # keys are the lanes' twins' keys, each as often as lanes share it
    expect = Counter(k for lane in plan.lanes for k in want[int(lane.seed)])
    got = Counter(lane_keys)
    seeds = sorted(want)
    shared = sum(1 for i, a in enumerate(seeds) for b in seeds[i + 1:]
                 if set(want[a]) & set(want[b]))
    return {"lanes": len(plan.lanes), "seeds": len(seeds),
            "rounds_recorded": sum(got.values()),
            "serial_twin_keys": got == expect,
            "seed_pairs_sharing_keys": shared}


def prologue_report() -> dict:
    """K3: every engine's round-key derivation IS the shared helper, and
    the sweep's lanes derive their serial twins' keys, disjoint across
    seeds."""
    from corro_sim_torch.engine import driver, replay, twin
    from corro_sim_torch.harness import cluster
    from corro_sim_torch.sweep import engine as sweep_engine

    aliases = {
        "sweep.engine.chunk_keys":
            sweep_engine.chunk_keys is driver.chunk_keys,
        "engine.twin.round_key": twin.round_key is driver.round_key,
        "engine.replay.round_key": replay.round_key is driver.round_key,
        "harness.cluster.round_key":
            cluster.round_key is driver.round_key,
    }
    site_fns = {
        "engine.driver.run_sim": (driver.run_sim, "chunk_keys("),
        "sweep.engine._Fleet.dispatch": (sweep_engine._Fleet.dispatch,
                                         "chunk_keys("),
        "engine.twin.run_twin": (twin.run_twin, "round_key("),
        "engine.replay.replay": (replay.replay, "round_key("),
    }
    sites = {}
    for name, (fn, needle) in site_fns.items():
        try:
            sites[name] = needle in inspect.getsource(fn)
        except (OSError, TypeError):
            sites[name] = False
    chains = {
        "chunk": _prologue_chain(
            lambda root, ci: driver.chunk_keys(root, ci, 8), "ci"),
        "round": _prologue_chain(driver.round_key, "r"),
    }
    lanes = _lane_report()
    violations = []
    for name, ok in sorted(aliases.items()):
        if not ok:
            violations.append(
                f"K3: {name} is not engine/driver.py's helper — the "
                "engine grew a private round-key derivation")
    for name, ok in sorted(sites.items()):
        if not ok:
            violations.append(
                f"K3: {name} no longer derives keys through the shared "
                "helper call site")
    if chains["chunk"] != CHUNK_PROLOGUE:
        violations.append(
            f"K3: chunk_keys derivation chain drifted — "
            f"{chains['chunk']} != {CHUNK_PROLOGUE}")
    if chains["round"] != ROUND_PROLOGUE:
        violations.append(
            f"K3: round_key derivation chain drifted — "
            f"{chains['round']} != {ROUND_PROLOGUE}")
    if not lanes["serial_twin_keys"]:
        violations.append(
            "K3: the sweep's lanes do not draw their serial twins' round "
            "keys")
    if lanes["seed_pairs_sharing_keys"]:
        violations.append(
            f"K3: {lanes['seed_pairs_sharing_keys']} pair(s) of lane "
            "seeds share a round key")
    return {
        "aliases": aliases,
        "call_sites": sites,
        "chains": chains,
        "lanes": lanes,
        "k3": {
            "status": "proven" if not violations else "violated",
            "violations": violations,
        },
    }


# ----------------------------------------------------- manifest + check

def build_report(programs=None) -> dict:
    """Compute the whole key-lineage report fresh from the tree.
    ``programs``: the names of :func:`key_programs` to run (default
    all)."""
    import torch

    out = {}
    for name, (family, thunk) in key_programs().items():
        if programs is not None and name not in programs:
            continue
        entry = thunk()
        entry["family"] = family
        out[name] = entry
    return {
        "torch_version": torch.__version__,
        "declared_tags": declared_tags(),
        "programs": out,
        "prologues": prologue_report(),
        "families": dict(KEY_FAMILIES),
    }


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
        "declared_tags": report["declared_tags"],
        "programs": report["programs"],
        "prologues": report["prologues"],
        "families": report["families"],
        # per-violation waivers: {"<program>:<verbatim violation>":
        # "<reason>"} — carried over from the committed manifest, never
        # generated
        "waivers": (load_golden(path) or {}).get("waivers", {}),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(golden, fh, indent=2, sort_keys=True)
        fh.write("\n")


def budget_problems(report: dict,
                    waivers: dict | None = None) -> list[str]:
    """The UNCONDITIONAL key-lineage asserts — golden or no golden:
    K1/K2 proven per program, K3 proven for the prologues and lanes, no
    anonymous (untracked-root) draws."""
    waivers = waivers or {}
    problems: list[str] = []

    def emit(prog, v):
        if f"{prog}:{v}" not in waivers:
            problems.append(f"{v} [{prog}]")

    for prog, rep in report["programs"].items():
        if "skipped" in rep:
            continue
        for v in rep["k1"]["violations"]:
            emit(prog, v)
        for v in rep["k2"]["violations"]:
            emit(prog, v)
        if rep["notes"].get("anonymous_draws"):
            emit(prog, (
                f"K1: {rep['notes']['anonymous_draws']} draw(s) from "
                "an untracked key root — the auditor cannot prove the "
                "stream disjoint"
            ))
    for v in report["prologues"]["k3"]["violations"]:
        emit("prologues", v)
    return problems


def golden_drift(report: dict, golden: dict | None) -> list[str]:
    """Drift vs the committed manifest: derivation forests (roots, draw
    addresses + shapes, splits, fold tags), prologue chains and the
    declared-tag registry all pinned exactly; re-baseline with ``audit
    --keys --update-golden``."""
    if golden is None:
        return [
            f"no key-lineage manifest at {GOLDEN_PATH} — run `python -m "
            "corro_sim_torch audit --keys --update-golden` and commit"
        ]
    drift: list[str] = []
    if golden.get("declared_tags") != report["declared_tags"]:
        drift.append(
            f"declared stream tags drifted "
            f"{golden.get('declared_tags')} -> {report['declared_tags']}"
            " — an intentional re-key must re-baseline every stream"
        )
    for prog, rep in report["programs"].items():
        gold = golden.get("programs", {}).get(prog)
        if gold is None:
            drift.append(f"manifest has no '{prog}' program entry")
            continue
        if "skipped" in rep or "skipped" in gold:
            if "skipped" in gold and "skipped" not in rep:
                drift.append(
                    f"'{prog}' is analyzable now but the manifest "
                    "holds a skip — re-baseline"
                )
            continue
        for field in ("roots", "draws", "splits", "fold_tags"):
            if gold.get(field) != rep[field]:
                drift.append(
                    f"'{prog}': {field} drifted "
                    f"{gold.get(field)} -> {rep[field]}"
                )
        for fam in ("k1", "k2"):
            gs = gold.get(fam, {}).get("status")
            if gs is not None and gs != rep[fam]["status"]:
                drift.append(
                    f"'{prog}': {fam} status drifted "
                    f"{gs!r} -> {rep[fam]['status']!r}"
                )
    gp = golden.get("prologues", {})
    if gp.get("chains") != report["prologues"]["chains"]:
        drift.append(
            f"prologue derivation chains drifted "
            f"{gp.get('chains')} -> {report['prologues']['chains']}"
        )
    return drift


def check(report: dict | None = None) -> dict:
    """The full ``audit --keys`` check: budgets + golden drift. Returns
    the report with ``problems``/``drift``/``ok`` attached and the
    ``corro_audit_key_*`` metrics exported."""
    if report is None:
        report = build_report()
    golden = load_golden()
    waivers = (golden or {}).get("waivers", {})
    problems = budget_problems(report, waivers)
    if golden is not None and golden.get(
        "torch_version"
    ) != report["torch_version"]:
        report["golden_skipped"] = (
            f"manifest written under torch {golden.get('torch_version')}, "
            f"running {report['torch_version']} — drift comparison "
            "skipped"
        )
        drift: list[str] = []
    else:
        drift = golden_drift(report, golden)
    report["problems"] = problems
    report["drift"] = drift
    report["ok"] = not problems and not drift
    export_metrics(report)
    return report


def export_metrics(report: dict) -> None:
    """``corro_audit_key_*`` info metrics: per-family check and violation
    counts (constants doc: utils/metrics.py)."""
    from corro_sim_torch.utils.metrics import (
        AUDIT_KEY_CHECKS_TOTAL,
        AUDIT_KEY_VIOLATIONS_TOTAL,
        counters,
    )

    checks = {"k1": 0, "k2": 0, "k3": 0}
    for rep in report["programs"].values():
        if "skipped" in rep:
            continue
        checks["k1"] += rep["k1"]["keys_checked"]
        checks["k2"] += rep["k2"]["tags_checked"]
    checks["k3"] += (
        len(report["prologues"]["aliases"])
        + len(report["prologues"]["call_sites"])
        + len(report["prologues"]["chains"])
    )
    for fam, n in checks.items():
        counters.inc(
            AUDIT_KEY_CHECKS_TOTAL, n=n,
            labels=f'{{family="{fam}"}}',
            help_="key-lineage checks evaluated by `audit --keys` "
                  "(analysis/keys.py)",
        )
    viol = {"k1": 0, "k2": 0, "k3": 0, "manifest": 0}
    for p in report.get("problems", []):
        fam = p[:2].lower()
        viol[fam if fam in viol else "manifest"] += 1
    for _ in report.get("drift", []):
        viol["manifest"] += 1
    for fam, n in viol.items():
        if n:
            counters.inc(
                AUDIT_KEY_VIOLATIONS_TOTAL, n=n,
                labels=f'{{family="{fam}"}}',
                help_="key-lineage violations + golden drift, "
                      "attributed to the contract family (K1/K2/K3; "
                      "'manifest' = structural drift)",
            )


def render_text(report: dict) -> list[str]:
    """Human-readable summary lines (the CLI's non-JSON output)."""
    lines = []
    for prog, rep in report["programs"].items():
        if "skipped" in rep:
            lines.append(f"keys     {prog:<16} SKIPPED: {rep['skipped']}")
            continue
        lines.append(
            f"keys     {prog:<16} roots {len(rep['roots'])} "
            f"draws {sum(len(v) for v in rep['draws'].values())} "
            f"splits {len(rep['splits'])} "
            f"tags {rep['k2']['tags_checked']} "
            f"k1 {rep['k1']['status']} k2 {rep['k2']['status']}"
        )
    pro = report["prologues"]
    lanes = pro.get("lanes", {})
    lines.append(
        f"keys     prologues        aliases "
        f"{sum(pro['aliases'].values())}/{len(pro['aliases'])} "
        f"call_sites {sum(pro['call_sites'].values())}"
        f"/{len(pro['call_sites'])} lanes {lanes.get('lanes')} "
        f"twin_keys {lanes.get('serial_twin_keys')} "
        f"k3 {pro['k3']['status']}"
    )
    if report.get("golden_skipped"):
        lines.append(f"keys     golden skipped: {report['golden_skipped']}")
    for p in report.get("problems", []) + report.get("drift", []):
        lines.append(f"PROBLEM  {p}")
    return lines
