"""The port's key-lineage auditor against the JAX package's, on the CPU.

The port records the lineage at ``prng.py``'s functions while each
program runs (``analysis/keys.py``); the JAX package walks the jaxpr.
On the same configs:

- the declared stream-tag registry equals the JAX package's;
- per program, the roots, the observed fold tags, the draw addresses,
  the splits and the K1/K2 verdicts equal the JAX package's (the draw
  SHAPES differ by design where the JAX package draws a lane axis or a
  stacked pair in one call: compared as addresses);
- the K3 prologue chains, the helper aliases and call sites hold, and a
  recorded sweep's lanes draw exactly their serial twins' round keys;
- a reused key, a tag collision, an undeclared tag and an anonymous draw
  each fail the audit naming the address; draws of disjoint counter
  ranges of one key are one draw;
- the committed manifest matches the tree.

Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from corro_sim_torch import prng
from corro_sim_torch.analysis import keys
from test_torch_cluster import one_torch_thread  # noqa: F401

PROGRAMS = ["audit/full", "audit/repair", "audit/workload", "audit/faults",
            "smoke/full", "smoke/repair", "chunk/full", "sweep/lanes",
            "sharded/full"]


@pytest.fixture(scope="module")
def port_report():
    return keys.build_report()


def test_declared_tag_registry_equals_the_jax_packages():
    from corro_sim.analysis import keys as r_keys

    assert keys.declared_tags() == r_keys.declared_tags()
    from corro_sim_torch.analysis.fx_audit import audit_config

    assert keys.expected_tags(audit_config()) == r_keys.expected_tags(
        __import__("corro_sim.analysis.jaxpr_audit",
                   fromlist=["audit_config"]).audit_config())


@pytest.mark.parametrize("program", PROGRAMS)
def test_lineage_and_verdicts_equal_the_jax_packages(program, port_report):
    from corro_sim.analysis import keys as r_keys

    family, thunk = r_keys.key_programs()[program]
    ref = thunk()
    assert "skipped" not in ref, ref
    port = port_report["programs"][program]
    assert port["family"] == family
    for field in ("roots", "fold_tags", "splits"):
        assert port[field] == ref[field], field
    assert sorted(port["draws"]) == sorted(ref["draws"])
    assert port["k1"]["status"] == ref["k1"]["status"] == "proven"
    assert port["k2"]["status"] == ref["k2"]["status"] == "proven"
    assert port["notes"] == {}


def test_k3_prologues_equal_the_jax_packages(port_report):
    from corro_sim.analysis import keys as r_keys

    pro = port_report["prologues"]
    assert pro["chains"] == {"chunk": r_keys.CHUNK_PROLOGUE,
                             "round": r_keys.ROUND_PROLOGUE}
    assert set(pro["aliases"]) == set(r_keys.prologue_report()["aliases"])
    assert all(pro["aliases"].values()) and all(pro["call_sites"].values())
    assert pro["lanes"]["serial_twin_keys"] is True
    assert pro["lanes"]["seed_pairs_sharing_keys"] == 0
    assert pro["lanes"]["lanes"] == 8 and pro["lanes"]["seeds"] == 4
    assert pro["k3"] == {"status": "proven", "violations": []}


def test_manifest_matches_the_tree_and_budgets_hold(port_report):
    golden = keys.load_golden()
    assert golden is not None and golden["torch_version"] == \
        torch.__version__
    assert keys.golden_drift(port_report, golden) == []
    assert keys.budget_problems(port_report) == []


def _scoped(fn, cfg=None) -> dict:
    root = np.array([0, 7], np.uint32)
    with keys.recording("key", steps_only=False) as rec:
        rec.new_scope(root)
        fn(root)
    return keys.analyze_records(rec.scopes, cfg=cfg)


def test_key_reuse_fails_the_audit_naming_the_address():
    def draws(root):
        k = prng.split(root, 2)[0]
        prng.uniform(k, (4,), "cpu")
        prng.uniform(k, (4,), "cpu")  # the same stream again

    rep = _scoped(draws)
    assert rep["k1"]["status"] == "violated"
    (v,) = rep["k1"]["violations"]
    assert "key/split2[0]" in v and "2 times" in v


def test_disjoint_counter_ranges_are_one_draw():
    def rows(root):
        k = prng.split(root, 2)[1]
        prng.random_bits(k, (2, 8), "cpu", offset=0)
        prng.random_bits(k, (2, 8), "cpu", offset=16)  # the next rows

    assert _scoped(rows)["k1"]["status"] == "proven"

    def overlap(root):
        k = prng.split(root, 2)[1]
        prng.random_bits(k, (2, 8), "cpu", offset=0)
        prng.random_bits(k, (2, 8), "cpu", offset=8)

    assert _scoped(overlap)["k1"]["status"] == "violated"


def test_tag_collision_fails_the_audit_naming_the_address():
    from corro_sim_torch.membership.swim import SWIM_ANNOUNCE_KEY_TAG

    def folds(root):
        prng.uniform(prng.fold_in(root, SWIM_ANNOUNCE_KEY_TAG), (2,), "cpu")
        prng.uniform(prng.split(prng.fold_in(root, SWIM_ANNOUNCE_KEY_TAG),
                                2)[0], (2,), "cpu")

    rep = _scoped(folds)
    assert rep["k2"]["status"] == "violated"
    assert any(f"fold({SWIM_ANNOUNCE_KEY_TAG})" in v and "'key'" in v
               for v in rep["k2"]["violations"])


def test_undeclared_tag_fails_under_a_real_config():
    from corro_sim_torch.analysis.fx_audit import audit_config

    def folds(root):
        prng.uniform(prng.fold_in(root, 12345), (2,), "cpu")

    assert _scoped(folds)["k2"]["status"] == "proven"  # no config: no check
    rep = _scoped(folds, cfg=audit_config())
    (v,) = rep["k2"]["violations"]
    assert "undeclared stream tag fold(12345)" in v


def test_anonymous_draws_are_an_unconditional_problem():
    def draws(root):
        prng.uniform(np.array([1, 2], np.uint32), (2,), "cpu")

    rep = _scoped(draws)
    assert rep["notes"] == {"anonymous_draws": 1}
    report = {"programs": {"toy": rep},
              "prologues": {"k3": {"violations": []}}}
    (p,) = keys.budget_problems(report)
    assert p.startswith("K1: 1 draw(s) from an untracked key root")


def test_check_exports_the_key_metrics(port_report):
    from corro_sim_torch.utils.metrics import counters

    out = keys.check(port_report)
    assert out["ok"]
    text = "\n".join(counters.render())
    for fam in ("k1", "k2", "k3"):
        assert f'corro_audit_key_checks_total{{family="{fam}"}}' in text
