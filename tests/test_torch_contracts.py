"""The port's program-contract auditor and fx dataflow engine against the
JAX package's, on the CPU.

- the dataflow passes on small traced graphs: influence through
  in-place updates (functionalized), host reads (any stops the trace),
  identity pass-through as inert, sort stability, liveness;
- per-feature x program vacuity statuses equal the JAX package's on the
  same configs (``contracts.contract_programs``), and the committed
  manifest matches the tree;
- a leaky dummy feature fails the vacuity proof, naming the leaked-into
  leaf, and a confined one proves (``tests/test_contracts.py``'s
  adversarial fixture, in torch);
- the delivery exchange census on gloo ranks is exactly one
  ``all_to_all_single`` per delivery, and a sneaked extra collective
  fails the budget;
- the golden round trip through ``audit --update-golden`` (the fx,
  contract and key-lineage manifests, written to a temporary directory)
  checks clean, and a tampered manifest is drift;
- the memory cross-check skips honestly with no measurement and gates
  once a card's artifact is there.

Tolerance: exact.
"""

import dataclasses
import json

import pytest
import torch

from corro_sim_torch.analysis import contracts
from corro_sim_torch.analysis import dataflow as df
from corro_sim_torch.analysis.fx_audit import Program
from test_torch_cluster import one_torch_thread  # noqa: F401


def _program(fn, *args, outs=None) -> Program:
    from corro_sim_torch.analysis.fx_audit import trace

    gm = trace(fn, *args)
    n_out = len(fn(*[a.clone() for a in args]))
    return Program(gm=gm, in_paths=[f"[{i}]" for i in range(len(args))],
                   out_paths=outs or [f"out{i}" for i in range(n_out)],
                   rounds=[0])


# ------------------------------------------------------------ dataflow

def test_influence_follows_in_place_updates():
    def f(a, b, c):
        a.add_(b)  # a now carries b
        return a * 2, c + 1, b

    prog = _program(f, torch.ones(3), torch.ones(3), torch.ones(3))
    masks = df.influence_masks(prog)
    assert masks[0] == 0b011 and masks[1] == 0b100 and masks[2] == 0b010
    assert df.influenced_outputs(prog, {1}) == {0, 2}
    # b passes through untouched but also feeds a: not inert; c is
    # influenced-into only its own output
    assert df.inert_inputs(prog) == set()


def test_identity_pass_through_is_inert():
    def f(a, b):
        return a + 1, b

    prog = _program(f, torch.ones(3), torch.ones(3))
    assert df.inert_inputs(prog) == {1}


@pytest.mark.parametrize("read", ["input", "constant", "branch"])
def test_host_reads_stop_the_trace(read):
    from corro_sim_torch.analysis.fx_audit import HostReadInStep

    def reads(a, b):
        if read == "input":
            k = int(a.sum().item())  # the host would decide from a
        elif read == "constant":
            k = int(torch.arange(4).sum().item())
        else:
            k = 2 if bool((a > 0).any()) else 3
        return (b * k,)

    with pytest.raises(HostReadInStep, match="tensor's value"):
        _program(reads, torch.ones(3), torch.ones(3))
    prog = _program(lambda a, b: (a * b,), torch.ones(3), torch.ones(3))
    assert df.host_read_eqns(prog) == []


def test_sort_census_and_liveness():
    def f(a):
        s = torch.sort(a, stable=True).values
        u = torch.sort(a).indices
        return s, u

    prog = _program(f, torch.arange(8.0))
    sorts = df.sort_eqns(prog)
    assert sorted(s["is_stable"] for s in sorts) == [False, True]

    def small(a):
        return (a + 1,)

    def big(a):
        t = a.repeat(64)  # a transient 64x the input
        return (t.sum() + a,)

    ls, lb = (df.liveness(_program(g, torch.ones(16)))
              for g in (small, big))
    assert lb.peak_bytes > ls.peak_bytes
    assert lb.transient_bytes >= 64 * 16 * 4
    assert ls.input_bytes == lb.input_bytes == 64


# --------------------------------------------------- program vacuity

@pytest.fixture(scope="module")
def port_report():
    return contracts.build_report(census=False)


@pytest.mark.parametrize("program", [name for name, *_ in
                                     contracts.contract_programs()])
def test_vacuity_statuses_equal_the_jax_packages(program, port_report):
    from corro_sim.analysis import contracts as r_contracts

    (_, cfg, repair, workload), = [
        row for row in r_contracts.contract_programs() if row[0] == program]
    ref = r_contracts.analyze_program(cfg, repair=repair, workload=workload)
    port = port_report["programs"][program]
    assert {k: v["status"] for k, v in port["vacuity"].items()} == {
        k: v["status"] for k, v in ref["vacuity"].items()}
    assert {k: v.get("leaves") for k, v in port["vacuity"].items()} == {
        k: v.get("leaves") for k, v in ref["vacuity"].items()}
    det = port["determinism"]
    assert det["unstable_sorts"] == ref["determinism"]["unstable_sorts"] == 0
    assert det["nondeterministic"] == 0 and det["host_reads"] == 0


def test_program_contracts_match_the_committed_manifest(port_report):
    golden = contracts.load_golden()
    assert golden is not None and golden["torch_version"] == \
        torch.__version__
    drift = contracts.golden_drift(port_report, golden)
    assert [d for d in drift if "collective" not in d] == []
    assert contracts.budget_problems(port_report) == []


@pytest.fixture()
def dummy_features(monkeypatch):
    from corro_sim_torch.engine import features

    for name in ("leaky", "confined"):
        monkeypatch.setitem(features._REGISTRY, name, features.FeatureLeaf(
            name=name, enabled=lambda cfg: True,
            build=lambda cfg, seed, device: torch.zeros(4,
                                                        dtype=torch.int32)))


def test_leaky_feature_fails_vacuity_confined_proves(dummy_features):
    def toy_step(core, leaky, confined):
        new_core = core + leaky  # the sneaked-in read
        return new_core, leaky, confined, new_core.sum()

    z = [torch.zeros(4, dtype=torch.int32) for _ in range(3)]
    prog = _program(toy_step, *z, outs=[
        "[0].core", "[0].features['leaky']", "[0].features['confined']",
        "[1]['writes']"])
    in_paths = ["[0].core", "[0].features['leaky']",
                "[0].features['confined']"]
    vac = contracts.prove_vacuity(prog, in_paths, prog.out_paths,
                                  {"leaky": False, "confined": False})
    assert vac["leaky"]["status"] == "violated"
    assert any(".core" in leak for leak in vac["leaky"]["leaks"]), vac
    assert vac["confined"]["status"] == "proven"
    report = {
        "programs": {"toy": {
            "vacuity": vac,
            "determinism": {"unstable_sorts": 0, "nondeterministic": 0,
                            "host_reads": 0},
        }},
        "collectives": {},
    }
    problems = contracts.budget_problems(report)
    assert len(problems) == 1 and "leaky" in problems[0]
    assert contracts.budget_problems(report, {"toy:leaky": "waiver"}) == []
    assert report["programs"]["toy"]["vacuity"]["leaky"][
        "status"].startswith("waived")


# --------------------------------------------------------- collectives

def test_delivery_exchange_census_is_exactly_one_all_to_all_single():
    c = contracts.delivery_exchange_census(ranks=2)
    assert c["per_delivery"] == {"all_to_all_single": 1}
    assert c["deliveries"] >= c["rounds"] >= 1
    report = {"programs": {}, "collectives": {"delivery_exchange": {
        "expected": {"all_to_all_single": 1}, **c}}}
    assert contracts.budget_problems(report) == []
    golden = contracts.load_golden()
    assert golden["collectives"]["delivery_exchange"]["per_delivery"] == \
        c["per_delivery"]


def test_sneaked_collective_fails_the_budget():
    c = contracts.delivery_exchange_census(ranks=2, sneak=True)
    assert c["per_delivery"] == {"all_reduce": 1, "all_to_all_single": 1}
    report = {"programs": {}, "collectives": {"delivery_exchange": {
        "expected": {"all_to_all_single": 1}, **c}}}
    (problem,) = contracts.budget_problems(report)
    assert "collective budget violated" in problem
    assert "all_reduce" in problem


# ------------------------------------------------ golden round trip

def test_golden_drift_roundtrip_via_update_golden(tmp_path, monkeypatch,
                                                  capsys):
    from corro_sim_torch import cli
    from corro_sim_torch.analysis import fx_audit
    from corro_sim_torch.analysis import keys

    paths = {mod: str(tmp_path / name) for mod, name in (
        (fx_audit, "fx.json"), (contracts, "contracts.json"),
        (keys, "keys.json"))}
    for mod, path in paths.items():
        monkeypatch.setattr(mod, "GOLDEN_PATH", path)
    assert cli.main(["--device", "cpu", "audit", "--contracts", "--keys",
                     "--update-golden"]) == 0
    out = capsys.readouterr().out
    assert out.count("golden   updated:") == 3
    for path in paths.values():
        assert json.load(open(path))["torch_version"] == torch.__version__
    assert cli.main(["audit", "--contracts", "--keys", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["contracts"]["drift"] == [] and \
        rep["keys"]["drift"] == []
    # tamper with each manifest: drift, exit 1
    g = json.load(open(paths[contracts]))
    g["programs"]["audit/full"]["memory"]["peak_bytes"] += 1
    json.dump(g, open(paths[contracts], "w"))
    k = json.load(open(paths[keys]))
    k["programs"]["audit/full"]["fold_tags"]["key"] = ["1"]
    json.dump(k, open(paths[keys], "w"))
    assert cli.main(["audit", "--contracts", "--keys", "--json"]) == 1
    rep = json.loads(capsys.readouterr().out)
    assert any("static memory drifted" in d
               for d in rep["contracts"]["drift"])
    assert any("fold_tags drifted" in d for d in rep["keys"]["drift"])


def test_check_attaches_problems_and_ok(port_report, monkeypatch):
    from corro_sim_torch.utils.metrics import counters

    rep = json.loads(json.dumps(port_report))
    rep["programs"]["audit/full"]["determinism"]["unstable_sorts"] = 1
    out = contracts.check(rep)
    assert not out["ok"]
    assert any("unstable sort" in p for p in out["problems"])
    text = "\n".join(counters.render())
    assert 'corro_audit_contract_violations_total{family="determinism"}' \
        in text


# ------------------------------------------------------ memory check

def test_hbm_crosscheck_skips_honestly_and_gates_when_measured(tmp_path):
    skipped = contracts.hbm_crosscheck(str(tmp_path))
    assert skipped["status"] == "skipped" and "reason" in skipped
    # a card's artifact: a CPU one is never taken for a measurement
    nodes = 64
    from corro_sim_torch.analysis.fx_audit import step_graph
    from corro_sim_torch.benchmarks import config5_cfg

    est = df.liveness(step_graph(config5_cfg(nodes), mode="fake"))
    for platform, peak, name in (("cpu", est.peak_bytes, "a"),
                                 ("cuda", est.peak_bytes, "b"),
                                 ("cuda", est.peak_bytes * 100, "c")):
        (tmp_path / f"{name}.json").write_text(json.dumps({
            "metric": f"config5_{nodes}_node_outage_catchup_rounds",
            "platform": platform, "nodes": nodes, "device_count": 1,
            "device_hbm": [{"peak_bytes_in_use": peak}]}))
    got = contracts.hbm_crosscheck(str(tmp_path))
    assert got["status"] == "checked"
    assert [r["artifact"] for r in got["rows"]] == ["b.json", "c.json"]
    assert [r["ok"] for r in got["rows"]] == [True, False]
    assert not got["ok"]
    assert dataclasses.asdict(est)["peak_bytes"] == \
        got["rows"][0]["static_peak_bytes_per_device"]
