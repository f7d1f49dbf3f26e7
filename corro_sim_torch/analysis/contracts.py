"""Program-contract auditor: static proofs over the traced step graphs.

The port's counterpart of ``corro_sim/analysis/contracts.py``. The
runtime vacuity oracle (:mod:`~corro_sim_torch.analysis.fx_audit`)
samples one config and one seed per claim; this module states the same
claims as DATAFLOW facts over the fx graph of the traced rounds — true
for all input values at once — and pins them to a committed manifest
(``analysis/golden/program_contracts.json``) checked by ``audit
--contracts``. Four contract families:

- **vacuity** — a disabled feature's leaves cannot influence any core
  state leaf or metric (:func:`~corro_sim_torch.analysis.dataflow.
  influence_masks`), proven for every registered feature x program
  pair: dict-style disabled features contribute no leaves
  (``no_leaves``), field-style placeholders (probe / fault_burst) get
  the taint proof. Taint scopes come from the registry
  (:func:`~corro_sim_torch.engine.features.leaf_provenance`);
- **collective budget** — the mesh's ``torch.distributed`` calls are not
  in an fx graph, so they are counted at run time, at the collective
  entry points, while one sharded cadence cycle runs on gloo ranks
  started through ``engine/ranks.py``: the delivery exchange is EXACTLY
  one ``all_to_all_single`` per delivery (``engine/sharding.py
  DELIVERY_EXCHANGE_COLLECTIVES``), and the whole round's census is
  golden-pinned;
- **determinism** — no nondeterministic nodes (float accumulation by
  index, global-generator draws), no unstable sorts, and the host reads
  baked into the graph counted (the port's analog of the JAX package's
  data-dependent ``while`` trip counts: the port has no device loops);
- **memory** — a buffer-liveness walk yielding a static peak-bytes
  estimate per program (:func:`~corro_sim_torch.analysis.dataflow.
  liveness`), committed as golden, plus a cross-check against measured
  peaks of the port's config 5/7 bench artifacts on the card where one
  exists (within :data:`HBM_TOLERANCE` x; with none the check records an
  honest skip).

Re-baseline: ``audit --contracts --update-golden`` rewrites the
manifest. Golden comparison is skipped under another torch version; the
BUDGET asserts (vacuity proven, one exchange per delivery, no
determinism violations) run everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import os

GOLDEN_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "golden",
    "program_contracts.json",
)

# static-vs-measured memory tolerance: the liveness walk ignores views
# and the caching allocator's rounding, so the estimate is only trusted
# to a factor; drift inside the band is tracked by the exact golden pin
HBM_TOLERANCE = 4.0

# the JAX package's collective names, spelled as torch.distributed's
_TORCH_COLLECTIVE = {"all_to_all": "all_to_all_single"}
# the torch.distributed calls the census counts
_COLLECTIVES = ("all_to_all_single", "all_to_all", "all_reduce",
                "all_gather", "all_gather_into_tensor", "broadcast",
                "reduce_scatter_tensor", "send", "recv", "gather",
                "scatter", "barrier")

FAMILIES = {
    "step": "single-device step programs (vacuity + determinism + "
            "memory proven on the audit/smoke representatives)",
    "sharded_step": "mesh-sharded step rounds (delivery exchange "
                    "collective budget: exactly one all_to_all_single "
                    "per delivery)",
}


def smoke_config():
    """The 32-node smoke config (the JAX package's)."""
    from corro_sim_torch.config import SimConfig

    return SimConfig(
        num_nodes=32, num_rows=32, num_cols=2, log_capacity=64,
        write_rate=0.5, swim_enabled=True, sync_interval=4,
    )


def contract_programs() -> list[tuple[str, object, bool, bool]]:
    """The step-family representative matrix:
    ``(name, cfg, repair, workload)`` rows."""
    from corro_sim_torch.analysis.fx_audit import audit_config

    audit_cfg = audit_config()
    smoke = smoke_config()
    return [
        ("audit/full", audit_cfg, False, False),
        ("audit/repair", audit_cfg, True, False),
        ("audit/workload", audit_cfg, False, True),
        ("smoke/full", smoke, False, False),
        ("smoke/repair", smoke, True, False),
    ]


# --------------------------------------------------------- per-program

def _state_rel(path: str) -> str | None:
    """Strip the leading ``[0]`` (the state position in both the inputs
    and the ``(state, metrics)`` outputs)."""
    return path[3:] if path.startswith("[0].") else None


def prove_vacuity(prog, in_paths: list[str], out_paths: list[str],
                  enabled: dict[str, bool]) -> dict[str, dict]:
    """The vacuity proof proper: taint every input leaf the registry
    attributes to each DISABLED feature, propagate, and require the
    influence confined to the feature's own output leaves. ``enabled``
    maps feature name -> enabled under this config (enabled pairs are
    the runtime oracle's, recorded as such)."""
    from corro_sim_torch.analysis import dataflow as df
    from corro_sim_torch.engine.features import leaf_provenance

    masks = df.influence_masks(prog)
    if len(masks) != len(out_paths):
        raise ValueError(f"{len(out_paths)} output paths for "
                         f"{len(masks)} graph outputs")
    in_feat = [leaf_provenance(_state_rel(p)) if _state_rel(p) else None
               for p in in_paths]
    out_feat = [leaf_provenance(_state_rel(p)) if _state_rel(p) else None
                for p in out_paths]
    vacuity: dict[str, dict] = {}
    for name in sorted(enabled):
        if enabled[name]:
            vacuity[name] = {"status": "enabled"}
            continue
        taint_idx = [i for i, f in enumerate(in_feat) if f == name]
        if not taint_idx:
            vacuity[name] = {"status": "no_leaves"}
            continue
        taint = 0
        for i in taint_idx:
            taint |= 1 << i
        leaks = [out_paths[o] for o, m in enumerate(masks)
                 if (m & taint) and out_feat[o] != name]
        vacuity[name] = (
            {"status": "proven", "leaves": len(taint_idx)}
            if not leaks else
            {"status": "violated", "leaves": len(taint_idx),
             "leaks": sorted(leaks)}
        )
    return vacuity


def analyze_program(cfg, repair: bool = False,
                    workload: bool = False) -> dict:
    """Every single-program contract family for one traced program:
    per-feature vacuity, determinism census, liveness estimate, inert
    carried leaves."""
    from corro_sim_torch.analysis import dataflow as df
    from corro_sim_torch.analysis.fx_audit import step_graph
    from corro_sim_torch.engine.features import feature_registry

    prog = step_graph(cfg, repair=repair, workload=workload)
    vacuity = prove_vacuity(
        prog, prog.in_paths, prog.out_paths,
        {name: leaf.enabled(cfg)
         for name, leaf in feature_registry().items()},
    )
    sorts = df.sort_eqns(prog)
    determinism = {
        "sorts_total": len(sorts),
        "unstable_sorts": sum(1 for s in sorts if not s["is_stable"]),
        "host_reads": len(df.host_read_eqns(prog)),
        "nondeterministic": len(df.nondeterministic_eqns(prog)),
    }
    inert = sorted(
        _state_rel(prog.in_paths[i]) for i in df.inert_inputs(prog)
        if _state_rel(prog.in_paths[i])
    )
    return {
        "vacuity": vacuity,
        "determinism": determinism,
        "memory": dataclasses.asdict(df.liveness(prog)),
        "inert_leaves": inert,
    }


# --------------------------------------------------------- collectives

def census_config():
    """The sharded census's config (the JAX package's: 16 nodes, 64 rows
    of 2 columns, the merge kernel forced on so the delivery merge takes
    the mesh's exchange)."""
    from corro_sim_torch.config import SimConfig

    return SimConfig(
        num_nodes=16, num_rows=64, num_cols=2, log_capacity=64,
        merge_kernel="on", sync_interval=4,
    ).validate()


def census_job(cfg, rounds: int, sneak: bool = False) -> dict:
    """On every rank: run ``rounds`` sharded rounds of ``cfg`` and count
    each ``torch.distributed`` collective call, by function, over the
    whole rounds and inside the delivery merge
    (``route_merge_sharded``). ``sneak``: add one ``all_reduce`` inside
    each delivery merge (the budget's own check). Rank 0's counts come
    back."""
    import contextlib
    from collections import Counter

    import torch

    from corro_sim_torch import prng
    from corro_sim_torch.core import delivery as delivery_mod
    from corro_sim_torch.engine.sharding import make_mesh
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.engine.step import sim_step

    dist = torch.distributed
    total: Counter = Counter()
    inside: Counter = Counter()
    deliveries = [0]
    in_delivery = [False]
    originals = {name: getattr(dist, name) for name in _COLLECTIVES
                 if hasattr(dist, name)}

    def counted(name, fn):
        def call(*a, **kw):
            total[name] += 1
            if in_delivery[0]:
                inside[name] += 1
            return fn(*a, **kw)
        return call

    merge = delivery_mod.route_merge_sharded

    def route_merge_sharded(*a, **kw):
        deliveries[0] += 1
        in_delivery[0] = True
        try:
            if sneak:
                dist.all_reduce(torch.zeros(1))
            return merge(*a, **kw)
        finally:
            in_delivery[0] = False

    mesh = make_mesh()
    state = init_state(cfg, seed=0, mesh=mesh, device=mesh.device)
    n = cfg.num_nodes
    alive = torch.ones((n,), dtype=torch.bool, device=mesh.device)
    part = torch.zeros((n,), dtype=torch.int32, device=mesh.device)
    root = prng.PRNGKey(0)
    with contextlib.ExitStack() as undo:
        for name, fn in originals.items():
            setattr(dist, name, counted(name, fn))
            undo.callback(setattr, dist, name, fn)
        delivery_mod.route_merge_sharded = route_merge_sharded
        undo.callback(setattr, delivery_mod, "route_merge_sharded", merge)
        for r in range(rounds):
            state, _ = sim_step(cfg, state, prng.fold_in(root, r), alive,
                                part, True, r, mesh=mesh)
    return {"total": dict(sorted(total.items())),
            "in_deliveries": dict(sorted(inside.items())),
            "deliveries": deliveries[0], "rounds": rounds}


def delivery_exchange_census(ranks: int = 2, sneak: bool = False) -> dict:
    """Run :func:`census_job` over one cadence cycle of
    :func:`census_config` on ``ranks`` gloo ranks (``engine/ranks.py``)
    and report the collectives per delivery and per round."""
    from corro_sim_torch.analysis.fx_audit import audit_rounds
    from corro_sim_torch.engine.ranks import run_ranks

    cfg = census_config()
    rounds = max(audit_rounds(cfg)) + 1
    got = run_ranks(census_job, ranks, cfg, rounds, sneak=sneak,
                    device="cpu")
    d = max(got["deliveries"], 1)
    per_delivery = {k: v / d for k, v in got["in_deliveries"].items()}
    return {
        "per_delivery": {k: int(v) if float(v).is_integer() else v
                         for k, v in per_delivery.items()},
        "total": got["total"],
        "deliveries": got["deliveries"],
        "rounds": got["rounds"],
        "ranks": ranks,
    }


# ------------------------------------------------------- HBM crosscheck

def _find_measured_peaks(root: str | None = None) -> list[dict]:
    """The port's config 5/7 bench artifacts measured on a card
    (``platform == "cuda"``) under the bench's output directory, with a
    non-null peak in ``device_hbm``: rows of ``{artifact, metric, nodes,
    devices, peak_bytes}``."""
    root = root or os.environ.get("CORRO_BENCH_OUT") or "bench_out"
    rows: list[dict] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return rows
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(root, name), encoding="utf-8") as fh:
                obj = json.load(fh)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            continue
        if not isinstance(obj, dict) or obj.get("platform") != "cuda":
            continue
        metric = str(obj.get("metric", ""))
        peaks = [d.get("peak_bytes_in_use") for d in obj.get(
            "device_hbm") or [] if isinstance(d, dict)
            and d.get("peak_bytes_in_use")]
        if peaks and obj.get("nodes") and (
                "config5" in metric or "config7" in metric):
            rows.append({"artifact": name, "metric": metric,
                         "nodes": int(obj["nodes"]),
                         "devices": int(obj.get("device_count") or 1),
                         "peak_bytes": max(peaks)})
    return rows


def hbm_crosscheck(root: str | None = None) -> dict:
    """Cross-check the static liveness estimate against measured peaks:
    for every config 5/7 artifact measured on the card, trace its exact
    config (``benchmarks.config5_cfg``/``config7_cfg`` at the artifact's
    node count, fake tensors) and require the measured per-device peak
    within ``HBM_TOLERANCE``x of the static estimate. No measured
    artifact records an honest skip, never a pass."""
    measured = _find_measured_peaks(root)
    if not measured:
        return {
            "status": "skipped",
            "reason": (
                "no config 5/7 bench artifact measured on the card under "
                "the bench output directory (bench_out/, gitignored); the "
                "check arms itself on the first one"
            ),
            "tolerance": HBM_TOLERANCE,
        }
    from corro_sim_torch.analysis import dataflow as df
    from corro_sim_torch.analysis.fx_audit import step_graph
    from corro_sim_torch.benchmarks import config5_cfg, config7_cfg

    rows = []
    ok = True
    for m in measured:
        cfg = (config5_cfg(m["nodes"]) if "config5" in m["metric"]
               else config7_cfg(m["nodes"]))
        est = df.liveness(step_graph(cfg, mode="fake"))
        per_dev = est.peak_bytes // max(m["devices"], 1)
        ratio = m["peak_bytes"] / max(per_dev, 1)
        in_band = (1 / HBM_TOLERANCE) <= ratio <= HBM_TOLERANCE
        ok = ok and in_band
        rows.append({**m, "static_peak_bytes_per_device": per_dev,
                     "ratio_measured_over_static": round(ratio, 3),
                     "ok": in_band})
    return {"status": "checked", "tolerance": HBM_TOLERANCE, "rows": rows,
            "ok": ok}


# ----------------------------------------------------- manifest + check

def build_report(census: bool = True) -> dict:
    """Compute every contract family fresh from the tree. ``census``:
    run the collective census on gloo ranks (else recorded as
    skipped)."""
    import torch

    from corro_sim_torch.engine.sharding import DELIVERY_EXCHANGE_COLLECTIVES

    programs = {
        name: analyze_program(cfg, repair=repair, workload=workload)
        for name, cfg, repair, workload in contract_programs()
    }
    expected = {_TORCH_COLLECTIVE.get(k, k): v
                for k, v in DELIVERY_EXCHANGE_COLLECTIVES.items()}
    return {
        "torch_version": torch.__version__,
        "programs": programs,
        "collectives": {
            "delivery_exchange": {
                "expected": expected,
                **(delivery_exchange_census() if census
                   else {"skipped": "census not asked for"}),
            },
        },
        "hbm_crosscheck": hbm_crosscheck(),
        "families": dict(FAMILIES),
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
        "programs": report["programs"],
        "collectives": {
            k: {kk: vv for kk, vv in v.items() if kk != "expected"}
            for k, v in report["collectives"].items()
        },
        "families": report["families"],
        # per-pair vacuity waivers: {"<program>:<feature>": "<reason>"}
        # — carried over from the committed manifest, never generated
        "waivers": (load_golden(path) or {}).get("waivers", {}),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(golden, fh, indent=2, sort_keys=True)
        fh.write("\n")


def budget_problems(report: dict,
                    waivers: dict | None = None) -> list[str]:
    """The UNCONDITIONAL contract asserts — golden or no golden: vacuity
    proven (or explicitly waived), zero determinism violations, and the
    declared collective budget per delivery."""
    waivers = waivers or {}
    problems: list[str] = []
    for prog, rep in report["programs"].items():
        for feat, v in rep["vacuity"].items():
            if v["status"] != "violated":
                continue
            key = f"{prog}:{feat}"
            if key in waivers:
                v["status"] = f"waived: {waivers[key]}"
                continue
            problems.append(
                f"vacuity violated: disabled feature '{feat}' leaves "
                f"influence non-feature outputs of '{prog}': "
                f"{v['leaks'][:6]}"
            )
        det = rep["determinism"]
        if det["unstable_sorts"]:
            problems.append(
                f"determinism: {det['unstable_sorts']} unstable sort "
                f"node(s) in '{prog}' — equal keys may reorder on the "
                "card"
            )
        if det["nondeterministic"]:
            problems.append(
                f"determinism: {det['nondeterministic']} "
                f"nondeterministic node(s) in '{prog}'"
            )
    for name, c in report["collectives"].items():
        if "skipped" in c:
            continue
        census = c.get("per_delivery", {})
        expected = c.get("expected", {})
        if census != expected or not c.get("deliveries"):
            diff = {
                op: (expected.get(op, 0), census.get(op, 0))
                for op in set(census) | set(expected)
                if census.get(op, 0) != expected.get(op, 0)
            }
            problems.append(
                f"collective budget violated in '{name}': per-"
                f"collective per delivery (expected, found): {diff} over "
                f"{c.get('deliveries', 0)} deliveries"
            )
    return problems


def _vac_status(v: dict) -> str:
    """Status normalized for drift comparison: a waived pair reads
    'violated'."""
    s = v["status"]
    return "violated" if s.startswith("waived") else s


def golden_drift(report: dict, golden: dict | None) -> list[str]:
    """Drift vs the committed manifest: vacuity statuses, determinism
    counts, memory peaks, inert leaves and the collective censuses all
    pinned exactly; re-baseline with ``audit --contracts
    --update-golden``."""
    if golden is None:
        return [
            f"no contract manifest at {GOLDEN_PATH} — run `python -m "
            "corro_sim_torch audit --contracts --update-golden` and commit"
        ]
    drift: list[str] = []
    for prog, rep in report["programs"].items():
        gold = golden.get("programs", {}).get(prog)
        if gold is None:
            drift.append(f"manifest has no '{prog}' program entry")
            continue
        for feat, v in rep["vacuity"].items():
            gv = gold.get("vacuity", {}).get(feat)
            if gv is None:
                drift.append(
                    f"'{prog}': feature '{feat}' has no manifest "
                    "vacuity entry (new feature — re-baseline)"
                )
            elif _vac_status(gv) != _vac_status(v):
                drift.append(
                    f"'{prog}': vacuity status of '{feat}' drifted "
                    f"{gv['status']!r} -> {v['status']!r}"
                )
        if gold.get("determinism") != rep["determinism"]:
            drift.append(
                f"'{prog}': determinism census drifted "
                f"{gold.get('determinism')} -> {rep['determinism']}"
            )
        gm, rm = gold.get("memory", {}), rep["memory"]
        if gm != rm:
            drift.append(
                f"'{prog}': static memory drifted — peak "
                f"{gm.get('peak_bytes')} -> {rm['peak_bytes']} bytes "
                f"({rm['peak_bytes'] - (gm.get('peak_bytes') or 0):+d})"
            )
        if gold.get("inert_leaves") != rep["inert_leaves"]:
            drift.append(
                f"'{prog}': inert-leaf set drifted "
                f"{gold.get('inert_leaves')} -> {rep['inert_leaves']}"
            )
    for name, c in report["collectives"].items():
        if "skipped" in c:
            continue
        gold = golden.get("collectives", {}).get(name)
        if gold is None:
            drift.append(f"manifest has no '{name}' collective entry")
            continue
        for layer in ("per_delivery", "total"):
            gc = gold.get(layer)
            if gc is not None and gc != c.get(layer):
                drift.append(
                    f"'{name}' {layer} collective census drifted "
                    f"{gc} -> {c.get(layer)}"
                )
    hc = report.get("hbm_crosscheck", {})
    if hc.get("status") == "checked" and not hc.get("ok"):
        for row in hc["rows"]:
            if not row["ok"]:
                drift.append(
                    f"static memory estimate out of band for "
                    f"{row['metric']}: measured {row['peak_bytes']} vs "
                    f"static {row['static_peak_bytes_per_device']} "
                    f"(ratio {row['ratio_measured_over_static']}, "
                    f"tolerance {HBM_TOLERANCE}x)"
                )
    return drift


def check(report: dict | None = None, census: bool = True) -> dict:
    """The full ``audit --contracts`` check: budgets + golden drift.
    Returns the report with ``problems``/``drift``/``ok`` attached and
    the ``corro_audit_contract_*`` metrics exported."""
    if report is None:
        report = build_report(census=census)
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
    """``corro_audit_contract_*`` info metrics: per-family check and
    violation counts (constants doc: utils/metrics.py)."""
    from corro_sim_torch.utils.metrics import (
        AUDIT_CONTRACT_CHECKS_TOTAL,
        AUDIT_CONTRACT_VIOLATIONS_TOTAL,
        counters,
    )

    fams: dict[str, int] = {
        "vacuity": 0, "determinism": 0, "memory": 0, "collectives": 0,
    }
    for rep in report["programs"].values():
        fams["vacuity"] += len(rep["vacuity"])
        fams["determinism"] += 1
        fams["memory"] += 1
    fams["collectives"] += sum(
        1 for c in report["collectives"].values() if "skipped" not in c
    )
    for fam, n in fams.items():
        counters.inc(
            AUDIT_CONTRACT_CHECKS_TOTAL, n=n,
            labels=f'{{family="{fam}"}}',
            help_="program-contract checks evaluated by "
                  "`audit --contracts` (analysis/contracts.py)",
        )

    def drift_family(row: str) -> str:
        if "vacuity" in row:
            return "vacuity"
        if "determinism" in row:
            return "determinism"
        if "collective" in row:
            return "collectives"
        if "memory" in row or "inert" in row:
            return "memory"
        return "manifest"  # structural rows (missing program/entry)

    viol = {"vacuity": 0, "determinism": 0, "collectives": 0, "memory": 0,
            "manifest": 0}
    for p in report.get("problems", []):
        if p.startswith("vacuity"):
            viol["vacuity"] += 1
        elif p.startswith("determinism"):
            viol["determinism"] += 1
        elif p.startswith("collective"):
            viol["collectives"] += 1
        else:
            viol["manifest"] += 1
    for d in report.get("drift", []):
        viol[drift_family(d)] += 1
    for fam, n in viol.items():
        if n:
            counters.inc(
                AUDIT_CONTRACT_VIOLATIONS_TOTAL, n=n,
                labels=f'{{family="{fam}"}}',
                help_="program-contract violations + golden drift, "
                      "attributed to the contract family the row "
                      "belongs to ('manifest' = structural drift)",
            )


def render_text(report: dict) -> list[str]:
    """Human-readable summary lines (the CLI's non-JSON output)."""
    lines = []
    for prog, rep in report["programs"].items():
        vac = rep["vacuity"]
        proven = sum(
            1 for v in vac.values()
            if v["status"] in ("proven", "no_leaves")
            or v["status"].startswith("waived")
        )
        det = rep["determinism"]
        mem = rep["memory"]
        lines.append(
            f"contract {prog:<16} vacuity {proven}/{len(vac)} "
            f"sorts {det['sorts_total']}(unstable "
            f"{det['unstable_sorts']}) host_reads {det['host_reads']} "
            f"peak {mem['peak_bytes']} B"
        )
    for name, c in report["collectives"].items():
        if "skipped" in c:
            lines.append(f"contract {name:<16} SKIPPED: {c['skipped']}")
        else:
            lines.append(
                f"contract {name:<16} per_delivery={c.get('per_delivery')}"
                f" total={c.get('total')} "
                f"({c.get('deliveries')} deliveries, {c.get('ranks')} "
                "gloo ranks)"
            )
    hc = report.get("hbm_crosscheck", {})
    lines.append(
        f"contract hbm_crosscheck  {hc.get('status')}"
        + (f": {hc.get('reason')}" if hc.get("reason") else "")
    )
    if report.get("golden_skipped"):
        lines.append(f"contract golden skipped: {report['golden_skipped']}")
    for p in report.get("problems", []) + report.get("drift", []):
        lines.append(f"PROBLEM  {p}")
    return lines
