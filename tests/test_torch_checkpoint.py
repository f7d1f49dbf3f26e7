"""Parity, sim checkpoints (corro_sim_torch.io.checkpoint and
``run_sim(resume=, checkpoint_path=, checkpoint_every=)``), on the CPU.

A run killed at a chunk boundary (an exception out of ``on_chunk``,
after chunk 1) and resumed from its token ends equal to the run that was
never killed: every state leaf, every metric of every round, the rounds
and the converged round (tolerance: exact), in both driver loops. The
cases of tests/test_soak_resume.py at its sizes, then the same across
backends: a token the JAX package writes resumes on the port, a token
the port writes resumes on the JAX package, and the two write the same
keys and dtypes. The committed JAX token (tests/fixtures/
sim_token_jax_64.npz, used by chip_smoke.py) is regenerated with the JAX
package and held equal.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from corro_sim.config import FaultConfig as RefFaultConfig
from corro_sim.config import SimConfig as RefSimConfig
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.io.checkpoint import load_sim_checkpoint as ref_load
from corro_sim_torch import config as pconfig
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.io.checkpoint import (
    load_sim_checkpoint,
    save_fork_checkpoint,
)
from corro_sim_torch.profile_slice import (
    CONFIG8_SOAK_ARGS,
    DIGESTS,
    TOKEN_FIXTURE,
    TOKEN_KILL_AFTER,
    TOKEN_NODES,
    TOKEN_ROUNDS,
    TOKEN_SPEC,
    config8_lane_config,
    run_digest,
    token_case,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(num_nodes=12, num_rows=16, num_cols=2, log_capacity=64,
              write_rate=0.6, sync_interval=4)
CFG = pconfig.SimConfig(**CFG_KW,
                        faults=pconfig.FaultConfig(loss=0.2)).validate()
REF_CFG = RefSimConfig(**CFG_KW, faults=RefFaultConfig(loss=0.2)).validate()
RUN = dict(max_rounds=64, chunk=8, seed=0)


class _Kill(Exception):
    pass


def _bomb(kill_after):
    def on_chunk(info):
        if kill_after is not None and info["chunk"] >= kill_after:
            raise _Kill
    return on_chunk


def _run(cfg=CFG, sched=None, resume=None, ckpt=None, every=0,
         kill_after=None, pipeline=None, **kw):
    return run_sim(
        cfg, init_state(cfg, seed=0, device="cpu"),
        sched or Schedule(write_rounds=8), **{**RUN, **kw}, device="cpu",
        resume=resume, checkpoint_path=ckpt, checkpoint_every=every,
        on_chunk=_bomb(kill_after), pipeline=pipeline,
    )


def _ref_run(cfg=REF_CFG, sched=None, resume=None, ckpt=None, every=0,
             kill_after=None, pipeline=None, **kw):
    return ref_run_sim(
        cfg, ref_init_state(cfg, seed=0), sched or RefSchedule(
            write_rounds=8), **{**RUN, **kw}, resume=resume,
        checkpoint_path=ckpt, checkpoint_every=every,
        on_chunk=_bomb(kill_after), pipeline=pipeline,
    )


def _ref_leaves(ref_state) -> dict:
    return {
        jax.tree_util.keystr(p).lstrip("."): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(ref_state)[0]
    }


def _assert_same_run(got, want_leaves: dict, want):
    assert got.rounds == want.rounds
    assert got.converged_round == want.converged_round
    assert set(got.metrics) == set(want.metrics)
    for k in want.metrics:
        assert np.array_equal(np.asarray(got.metrics[k]),
                              np.asarray(want.metrics[k])), k
    have = state_to_numpy(got.state)
    assert set(have) == set(want_leaves)
    for k, v in want_leaves.items():
        assert have[k].dtype == v.dtype and np.array_equal(have[k], v), k


def _kill_and_load(tmp_path, run, name="soak.ckpt.npz", load=None, **kw):
    path = str(tmp_path / name)
    with pytest.raises(_Kill):
        run(ckpt=path, every=1, kill_after=1, **kw)
    return path, (load or load_sim_checkpoint)(path)


@pytest.mark.parametrize("pipeline", [True, False])
def test_resume_bit_identical(tmp_path, pipeline):
    """Kill after chunk 1, resume: the final state, every stitched metric
    and the flight's gap curve equal the uninterrupted run's."""
    ref = _run(pipeline=pipeline)
    _, ck = _kill_and_load(tmp_path, _run, pipeline=pipeline)
    assert ck.rounds == ck.next_chunk * 8
    assert 0 < ck.rounds < ref.rounds
    res = _run(resume=ck, pipeline=pipeline)
    _assert_same_run(res, state_to_numpy(ref.state), ref)
    assert res.flight.series("gap") == ref.flight.series("gap")
    assert res.flight.events("resume")
    assert res.flight.meta.get("resumed_at_round") == ck.rounds
    assert res.flight.meta.get("resumed_from") == ck.path


@pytest.mark.parametrize("kill_after", [1, 3])
def test_checkpoint_cursor_carries_repair_selection(tmp_path, kill_after):
    """Tokens taken before the rings drain (chunk 0's) and after the
    switch to the repair step (chunk 2's) resume into the same
    full-to-repair chunk sequence; convergence is not tested before
    round 40, so the tail runs repair chunks."""
    kw = dict(min_rounds=40)
    ref = _run(**kw)
    assert ref.repair_chunks > 0
    path = str(tmp_path / "soak.ckpt.npz")
    with pytest.raises(_Kill):
        _run(ckpt=path, every=1, kill_after=kill_after, **kw)
    ck = load_sim_checkpoint(path)
    # on_chunk fires before the chunk's save
    assert ck.next_chunk == kill_after
    assert ck.cursor["repair_seen"] == (ck.cursor["repair_chunks"] > 0)
    if kill_after == 3:
        assert ck.cursor["repair_chunks"] > 0
    res = _run(resume=ck, **kw)
    # the count restarts from the cursor's: the run's total, as the JAX
    # package reports it
    assert res.repair_chunks == ref.repair_chunks
    _assert_same_run(res, state_to_numpy(ref.state), ref)


def test_resume_refuses_mismatches(tmp_path):
    _, ck = _kill_and_load(tmp_path, _run)
    other = dataclasses.replace(CFG, write_rate=0.5).validate()
    with pytest.raises(ValueError, match="config"):
        _run(cfg=other, resume=ck)
    with pytest.raises(ValueError, match="seed/chunk"):
        _run(resume=ck, seed=1)
    with pytest.raises(ValueError, match="seed/chunk"):
        _run(resume=ck, chunk=4)
    from corro_sim_torch.workload import make_workload

    wl = make_workload("zipf:alpha=1.0,rate=0.2,keys=8", CFG.num_nodes,
                       rounds=4, seed=0)
    with pytest.raises(ValueError, match="workload"):
        run_sim(CFG, init_state(CFG, seed=0, device="cpu"),
                Schedule(write_rounds=8), **RUN, device="cpu", resume=ck,
                workload=wl)
    with pytest.raises(ValueError, match="fork tokens only"):
        ck.refit(CFG, 0, 8)
    # a state of another shape is refused, never coerced
    small = dataclasses.replace(CFG, num_rows=8).validate()
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.install_state(init_state(small, device="cpu"))


def test_checkpoint_is_atomic(tmp_path):
    """No torn file: the staging file is gone and the token loads."""
    path = str(tmp_path / "soak.ckpt.npz")
    res = _run(ckpt=path, every=1)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    ck = load_sim_checkpoint(path)
    assert ck.cfg == CFG
    assert ck.metrics["gap"].shape[0] == ck.rounds
    assert res.checkpoint_seconds > 0
    assert len(res.flight.events("checkpoint")) == ck.next_chunk


NF_KW = dict(crash=((1, 12), (4, 12)), stale=((7, 4, 12),))


def _nf_setup():
    cfg = dataclasses.replace(
        CFG, node_faults=pconfig.NodeFaultConfig(**NF_KW)).validate()
    alive = np.ones((64, CFG.num_nodes), bool)
    alive[6:12, [1, 4, 7]] = False
    return cfg, alive


@pytest.mark.parametrize("pipeline", [True, False])
def test_resume_mid_node_fault_window_bit_identical(tmp_path, pipeline):
    """Killed after the victims went down and before their round-12
    wipe: the resume replays the wipes, and the epoch and snapshot
    leaves ride the token."""
    cfg, alive = _nf_setup()
    kw = dict(cfg=cfg, sched=Schedule(write_rounds=8, alive=alive),
              min_rounds=12, pipeline=pipeline)
    ref = _run(**kw)
    _, ck = _kill_and_load(tmp_path, _run, **kw)
    assert ck.rounds == 8
    assert "features/node_epoch" in ck.state_flat
    assert any(k.startswith("features/node_snapshot/")
               for k in ck.state_flat)
    assert ck.state_flat["features/node_snapshot/win"].dtype == np.uint32
    assert int(ck.state_flat["features/node_epoch"].sum()) == 0
    res = _run(resume=ck, **kw)
    _assert_same_run(res, state_to_numpy(ref.state), ref)
    assert int(res.state.features["node_epoch"].sum()) == 3


# ------------------------------------------------------- across backends

@pytest.fixture(scope="module")
def ref_soak(tmp_path_factory):
    """The JAX package's uninterrupted run, and its token after chunk 1
    (killed from on_chunk)."""
    tmp = tmp_path_factory.mktemp("ref")
    ref = _ref_run()
    path, ck = _kill_and_load(tmp, _ref_run, load=ref_load)
    return ref, path


@pytest.mark.parametrize("pipeline", [True, False])
def test_jax_token_resumes_on_the_port(ref_soak, pipeline):
    ref, path = ref_soak
    ck = load_sim_checkpoint(path)
    assert ck.cfg_dict == json.loads(json.dumps(
        dataclasses.asdict(CFG)))
    res = _run(resume=ck, pipeline=pipeline)
    _assert_same_run(res, _ref_leaves(ref.state), ref)


@pytest.mark.parametrize("write_pipeline", [True, False])
def test_port_token_resumes_on_the_jax_package(ref_soak, tmp_path,
                                               write_pipeline):
    ref, _ = ref_soak
    path, _ = _kill_and_load(tmp_path, _run, pipeline=write_pipeline)
    res = _ref_run(resume=ref_load(path), pipeline=not write_pipeline)
    assert res.rounds == ref.rounds
    assert res.converged_round == ref.converged_round
    for k in ref.metrics:
        assert np.array_equal(np.asarray(res.metrics[k]),
                              np.asarray(ref.metrics[k])), k
    want, got = _ref_leaves(ref.state), _ref_leaves(res.state)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_token_files_have_equal_keys_dtypes_and_headers(ref_soak,
                                                        tmp_path):
    _, ref_path = ref_soak
    path, _ = _kill_and_load(tmp_path, _run, name="port.npz")
    with np.load(ref_path) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k in ("__meta__", "__flight__"):
                continue
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k
        ha = json.loads(bytes(a["__meta__"]).decode())
        hb = json.loads(bytes(b["__meta__"]).decode())
    assert ha == hb
    # the flight lines load in the other package's recorder
    ck = load_sim_checkpoint(ref_path)
    assert ck.flight_lines and ref_load(path).flight_lines


def test_fork_token_refit_and_resume(tmp_path):
    """A fork token written from a port state: refit to a lane's config,
    resumed by the port and by the JAX package, to the same end."""
    base = _run(max_rounds=16, stop_on_convergence=False)
    path = str(tmp_path / "fork.npz")
    save_fork_checkpoint(path, cfg=CFG, state=base.state, seed=0, chunk=8,
                         fork_round=base.rounds, meta={"note": "t"})
    tok = load_sim_checkpoint(path)
    assert tok.is_fork and tok.fork_round == 16
    assert not any(k.startswith(("probe", "fault_burst", "features"))
                   for k in tok.state_flat)
    lossy = dataclasses.replace(
        CFG, faults=pconfig.FaultConfig(loss=0.3), write_rate=0.0
    ).validate()
    got = run_sim(lossy, init_state(lossy, seed=3, device="cpu"),
                  Schedule(write_rounds=0), max_rounds=64, chunk=8,
                  seed=3, device="cpu", resume=tok.refit(lossy, 3, 8))
    assert int(got.state.round) == 16 + got.rounds
    ref_lossy = dataclasses.replace(
        REF_CFG, faults=RefFaultConfig(loss=0.3), write_rate=0.0
    ).validate()
    rtok = ref_load(path)
    want = ref_run_sim(ref_lossy, ref_init_state(ref_lossy, seed=3),
                       RefSchedule(write_rounds=0), max_rounds=64, chunk=8,
                       seed=3, resume=rtok.refit(ref_lossy, 3, 8))
    _assert_same_run(got, _ref_leaves(want.state), want)


# ------------------------------------------------------ the JAX fixture

def _ref_token_case():
    """The JAX package's side of ``profile_slice.token_case``."""
    from corro_sim.faults.scenarios import make_scenario
    from corro_sim.io.checkpoint import _simconfig_from_dict

    args = CONFIG8_SOAK_ARGS
    sc = make_scenario(TOKEN_SPEC, TOKEN_NODES, rounds=args["rounds"],
                       write_rounds=args["write_rounds"], seed=0)
    base = _simconfig_from_dict(json.loads(json.dumps(
        dataclasses.asdict(config8_lane_config(TOKEN_NODES)))))
    run_kw = dict(max_rounds=args["max_rounds"], chunk=args["chunk"],
                  seed=0, min_rounds=max(sc.heal_round or 0,
                                         args["write_rounds"]))
    return sc.apply(base), sc.schedule(), run_kw


def write_jax_token(path: str):
    """Write the JAX token of ``profile_slice.token_case`` to ``path``;
    returns the JAX package's uninterrupted run."""
    cfg, sched, kw = _ref_token_case()
    full = ref_run_sim(cfg, ref_init_state(cfg, seed=0), sched,
                       pipeline=False, **kw)
    with pytest.raises(_Kill):
        ref_run_sim(cfg, ref_init_state(cfg, seed=0), sched,
                    pipeline=False, checkpoint_path=path,
                    checkpoint_every=1, on_chunk=_bomb(TOKEN_KILL_AFTER),
                    checkpoint_meta={"case": "token_jax_64"}, **kw)
    return full


@pytest.fixture(scope="module")
def jax_token(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tok.npz")
    return path, write_jax_token(path)


def test_committed_jax_token_equals_a_regenerated_one(jax_token):
    path, full = jax_token
    committed = os.path.join(REPO, TOKEN_FIXTURE)
    assert os.path.getsize(committed) < 200_000
    with np.load(committed) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert json.loads(bytes(a["__meta__"]).decode()) == \
            json.loads(bytes(b["__meta__"]).decode())
        for k in a.files:
            if k == "__flight__":  # stamps host walls
                continue
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # the pins: the uninterrupted JAX run
    leaves = _ref_leaves(full.state)
    assert run_digest(leaves, full.metrics) == DIGESTS["token_jax_64"]
    assert (full.rounds, full.converged_round) == TOKEN_ROUNDS


@pytest.mark.parametrize("pipeline", [True, False])
def test_committed_jax_token_resumes_to_its_pin(pipeline):
    ck = load_sim_checkpoint(os.path.join(REPO, TOKEN_FIXTURE))
    cfg, sched, kw = token_case(device="cpu")
    assert ck.cfg == cfg and ck.next_chunk == TOKEN_KILL_AFTER
    res = run_sim(cfg, init_state(cfg, seed=0, device="cpu"), sched,
                  resume=ck, pipeline=pipeline, **kw)
    assert (res.rounds, res.converged_round) == TOKEN_ROUNDS
    assert run_digest(state_to_numpy(res.state), res.metrics) == \
        DIGESTS["token_jax_64"]
