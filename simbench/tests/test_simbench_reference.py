"""The plain reference against the port's CPU path at tiny cluster sizes,
and the judge's teeth: a corrupted merged plane, a dropped or altered
write, and a run whose step is broken underneath come out as not
correct.

Run with ``python -m pytest simbench/tests`` from the repository root.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig
from corro_sim_torch.core import crdt
from corro_sim_torch.engine import driver as driver_mod
from corro_sim_torch.engine import step as step_mod
from corro_sim_torch.engine.state import clone_state, init_state
from simbench import cells, run
from simbench import schedule as sched
from simbench.reference import draws, oracle
from simbench.tests.tiny_root import make_tiny_root

CPU = torch.device("cpu")
CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]
SEED = 2 ** 31 + 11  # past 32 signed bits: any whole-number seed is taken


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def _cell(tiny, name):
    return cells.resolve_cell(cells.load_benchmark(tiny), name, tiny)


def _cluster(cell, seed, device=CPU):
    """One cluster of ``cell`` through the port, as a window runs it."""
    cfg = SimConfig(**cell.config["sim"])
    state = init_state(cfg, seed=seed, device=device)
    return driver_mod.run_sim(
        cfg, state, run.make_schedule(cell.traffic, cfg.num_nodes),
        seed=seed, device=device, **sched.run_args(cell.traffic))


def _judge(cell, seed, res, out=None):
    sim, tr = cell.config["sim"], cell.traffic
    n, wr = int(sim["num_nodes"]), int(tr["write_rounds"])
    args = sched.run_args(tr)
    writes = draws.draw_writes(sim, seed, sched.alive_rows(tr, wr, n), wr,
                               args["chunk"])
    got = oracle.judge(
        writes, out if out is not None else run.host_outputs(res.state),
        num_nodes=n, num_rows=int(sim["num_rows"]),
        num_cols=int(sim["num_cols"]),
        alive_end=sched.alive_row(tr, res.rounds - 1, n),
        converge=tr["mode"] == "converge")
    got["rounds_wrong"] = oracle.rounds_wrong(
        res.converged_round, res.rounds, chunk=args["chunk"],
        min_rounds=args["min_rounds"], converge=tr["mode"] == "converge",
        fixed_rounds=args["max_rounds"])
    return writes, got


def test_draws_follow_the_generator_bit_for_bit():
    key = prng.fold_in(prng.PRNGKey(SEED), 7)
    np.testing.assert_array_equal(draws.split(key, 9), prng.split(key, 9))
    np.testing.assert_array_equal(
        draws.fold_in(key, 3), prng.fold_in(key, 3))
    np.testing.assert_array_equal(
        draws.uniform(key, 4096), prng.uniform(key, (4096,), CPU).numpy())
    np.testing.assert_array_equal(
        draws.randint(key, 4096, 0, 1 << 20),
        prng.randint(key, (4096,), 0, 1 << 20, CPU).numpy())
    np.testing.assert_array_equal(
        draws.randint(key, 512, 0, 3), prng.randint(key, (512,), 0, 3, CPU)
        .numpy())


def test_bfloat16_rounding():
    x = np.array([0.2, 0.0125, 1.0, 0.333333], np.float32)
    ref = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(draws._bf16(x), ref)


@pytest.mark.parametrize("name", CELLS)
def test_reference_holds_the_port_cpu_path(tiny, name):
    cell = _cell(tiny, name)
    seed = sched.cluster_seed(SEED, 0)
    res = _cluster(cell, seed)
    writes, got = _judge(cell, seed, res)
    assert writes["node"].size > 0
    assert got == {k: 0 for k in oracle.CHECKS}
    # the port's own log holds exactly the writes the reference drew
    log_head = res.state.log.head.numpy()
    assert log_head.sum() == writes["node"].size


@pytest.fixture(scope="module")
def converged(tiny):
    cell = _cell(tiny, "north_star_10k.converge")
    seed = sched.cluster_seed(SEED, 1)
    res = _cluster(cell, seed)
    return cell, seed, res, run.host_outputs(res.state)


def _copy(out):
    return {k: np.array(v, copy=True) for k, v in out.items()}


def test_a_corrupted_merged_plane_is_caught(converged):
    cell, seed, res, out = converged
    writes, got = _judge(cell, seed, res, out)
    assert got["cells_wrong"] == 0
    r, c = int(writes["row"][0]), int(writes["col"][0])
    bad = _copy(out)
    bad["vr"][5, r, c] += 1  # a value nobody wrote
    assert _judge(cell, seed, res, bad)[1]["cells_wrong"] == 1
    bad = _copy(out)
    bad["cv"][7, r, c] = 0  # the winner lost at one node
    bad["vr"][7, r, c] = oracle.NEG
    bad["site"][7, r, c] = -1
    assert _judge(cell, seed, res, bad)[1]["cells_wrong"] >= 1
    bad = _copy(out)
    unwritten = np.setdiff1d(np.arange(out["cl"].shape[1]), writes["row"])
    bad["cl"][3, unwritten[0]] = 1  # a row nobody wrote exists
    assert _judge(cell, seed, res, bad)[1]["cells_wrong"] >= 1


def test_a_dropped_write_is_caught(converged):
    cell, seed, res, out = converged
    writer = int(out["log_head"].argmax())
    bad = _copy(out)
    bad["log_head"][writer] -= 1  # the writer's log lost its last write
    got = _judge(cell, seed, res, bad)[1]
    assert got["writes_wrong"] >= 1
    bad = _copy(out)
    bad["head"][9, writer] -= 1  # a live node misses one write
    assert _judge(cell, seed, res, bad)[1]["heads_wrong"] >= 1
    bad = _copy(out)
    bad["log_cells"][writer, 0, 0, oracle.CELL_VR] ^= 1  # logged wrong
    assert _judge(cell, seed, res, bad)[1]["writes_wrong"] >= 1
    bad = _copy(out)
    bad["log_cells"][writer, 0, 0, oracle.CELL_CV] = 1 << 20
    assert _judge(cell, seed, res, bad)[1]["cv_wrong"] >= 1


def test_a_pinned_col_version_is_held_exactly(converged):
    cell, seed, res, out = converged
    sim = cell.config["sim"]
    writes = _judge(cell, seed, res, out)[0]
    pinned, prior = oracle.cv_pinned(writes, num_nodes=int(sim["num_nodes"]),
                                     num_cols=int(sim["num_cols"]))
    first = np.nonzero(pinned & (prior == 0))[0][0]
    node, ver = int(writes["node"][first]), 1 + int(
        (writes["node"][:first] == writes["node"][first]).sum())
    bad = _copy(out)
    bad["log_cells"][node, ver - 1, 0, oracle.CELL_CV] = 2  # inside the bounds
    assert oracle.cv_pinned(writes, num_nodes=int(sim["num_nodes"]),
                            num_cols=int(sim["num_cols"]))[0][first]
    assert _judge(cell, seed, res, bad)[1]["cv_wrong"] >= 1


def _stamps(cell, seed, rounds):
    """Each write's logged col_version over the first ``rounds`` write
    rounds, and the writer's cv plane at the start of each round, from
    the port's CPU path stepped one round to a chunk."""
    cfg = SimConfig(**cell.config["sim"])
    tr = cell.traffic
    n = cfg.num_nodes
    args = dict(sched.run_args(tr), chunk=1, stop_on_convergence=False,
                min_rounds=rounds)
    planes = [init_state(cfg, seed=seed, device=CPU).table.cv.numpy()]
    for r in range(1, rounds + 1):
        res = driver_mod.run_sim(
            cfg, init_state(cfg, seed=seed, device=CPU),
            run.make_schedule(tr, n), seed=seed, device=CPU,
            **dict(args, max_rounds=r))
        planes.append(res.state.table.cv.numpy())
    writes = draws.draw_writes(cell.config["sim"], seed,
                               sched.alive_rows(tr, rounds, n), rounds, 1)
    ver = oracle.versions(writes["node"].astype(np.int64), n)[0]
    log = res.state.log.cells.numpy()
    return writes, log[writes["node"], ver - 1, 0, oracle.CELL_CV], planes


def _own_stamps(real):
    """``local_write`` stamping from the writer's own writes alone: a
    col_version it received is ignored."""
    def local_write(state, writer, row, col, vr, is_delete, ncells, valid,
                    row_lo=0):
        own = state.site == writer.view(-1, 1, 1)
        masked = dataclasses.replace(state, cv=torch.where(own, state.cv, 0))
        _t, ch_cv, ch_cl, ch_vr = real(masked, writer, row, col, vr,
                                       is_delete, ncells, valid, row_lo)
        n, s = row.shape
        live = valid[:, None] & (torch.arange(s)[None, :] < ncells[:, None])
        site = writer[:, None].expand(n, s).to(torch.int32)
        table = crdt.apply_cell_changes(
            state, (site - row_lo).reshape(-1), row.reshape(-1),
            col.reshape(-1), ch_cv.reshape(-1), ch_vr.reshape(-1),
            site.reshape(-1), ch_cl.reshape(-1), live.reshape(-1))
        return table, ch_cv, ch_cl, ch_vr
    return local_write


def test_each_stamp_is_one_more_than_the_writer_held(tiny, monkeypatch):
    """The stage the whole-run judge only bounds, followed round by round
    from the port's own state: a write is stamped one more than the
    col_version its writer held, also where that came from another
    writer; a stamp that ignores received col_versions is caught."""
    cell = _cell(tiny, "catchup_16k.no_outage")
    seed = sched.cluster_seed(SEED, 3)
    writes, cv, planes = _stamps(cell, seed, 6)
    sim = cell.config["sim"]
    pinned, _prior = oracle.cv_pinned(writes, num_nodes=int(sim["num_nodes"]),
                                      num_cols=int(sim["num_cols"]))
    assert oracle.stamps_wrong(writes, cv, planes) == 0
    # not vacuous: many stamps are not fixed by the draws, and some carry
    # a col_version the writer received
    held = np.array([planes[r][w, i, j] for r, w, i, j in zip(
        writes["round"], writes["node"], writes["row"], writes["col"])])
    assert (~pinned).sum() >= 20
    assert ((held > 0) & ~pinned).sum() >= 5
    monkeypatch.setattr(step_mod, "local_write",
                        _own_stamps(step_mod.local_write))
    writes, cv, planes = _stamps(cell, seed, 6)
    assert oracle.stamps_wrong(writes, cv, planes) >= 5


def test_a_fixed_mix_added_by_files_runs_correct(tiny, capsys):
    """A mix of ``mode: fixed`` (each cluster runs a set number of rounds,
    writing in all of them), added by a file and an entry alone, runs and
    is judged correct."""
    mix = json.loads((tiny / "simbench/traffic/converge.json").read_text())
    mix.update(mode="fixed", rounds=24, write_rounds=24, min_rounds=24,
               max_rounds=24, trace={"from_round": 8, "rounds": 8})
    (tiny / "simbench/traffic/fixed24.json").write_text(json.dumps(mix))
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "north_star_10k.fixed24",
                               "config": "north_star_10k",
                               "traffic": "fixed24", "chips": 1, "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "north_star_10k.converge" in m.get("workloads", ()):
            m["workloads"].append("north_star_10k.fixed24")
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    line = _run(tiny, "north_star_10k.fixed24", capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert "round_ms.north_star" in line["metrics"]
    assert "converge_s.north_star" not in line["metrics"]


def test_a_wrong_round_is_caught():
    kw = dict(chunk=8, min_rounds=16, converge=True)
    assert oracle.rounds_wrong(20, 24, **kw) == 0
    assert oracle.rounds_wrong(None, 24, **kw) == 1
    assert oracle.rounds_wrong(12, 24, **kw) == 1  # before the last chunk
    assert oracle.rounds_wrong(16, 16, **kw) == 1  # not past min_rounds
    assert oracle.rounds_wrong(None, 40, chunk=8, min_rounds=40,
                               converge=False, fixed_rounds=40) == 0


def _run(tiny, name, capsys, seconds=1) -> dict:
    rc = run.main(["--workload", name, "--seed", str(SEED), "--seconds",
                   str(seconds), "--trace", "0"], device=CPU, root=tiny)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny, capsys, name):
    line = _run(tiny, name, capsys)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert all(v["value"] == 0 == v["limit"] for v in line["checks"].values())


def _broken_step(fault):
    real = driver_mod.sim_step

    def step(cfg, state, key, alive, part, we, round_idx, **kw):
        n = cfg.num_nodes
        if fault == "unchanged":
            _new, m = real(cfg, clone_state(state), key, alive, part, we,
                           round_idx, **kw)
            return state, m
        planes = ("cv", "vr", "site", "cl")
        kept = {p: getattr(state.table, p)[n // 2:].clone() for p in planes}
        new, m = real(cfg, state, key, alive, part, we, round_idx, **kw)
        if fault == "half_left_out":
            for p in planes:
                getattr(new.table, p)[n // 2:] = kept[p]
        elif fault == "answer_altered" and round_idx >= 9:
            # node 0 holds, in its first cell, a value nobody wrote
            new.table.cl[0, 0] = 1
            new.table.cv[0, 0, 0] = 1000
            new.table.vr[0, 0, 0] = (1 << 20) - 1
        return new, m
    return step


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("name", ["north_star_10k.converge",
                                  "catchup_16k.outage30"])
def test_a_broken_step_is_not_correct(tiny, capsys, monkeypatch, fault,
                                      name):
    monkeypatch.setattr(driver_mod, "sim_step", _broken_step(fault))
    # a window long enough to finish a cluster at the broken step's pace
    line = _run(tiny, name, capsys, seconds=4)
    assert line["correct"] is False
    assert line["checks"]["none_judged"]["value"] == 0


@pytest.mark.cuda
def test_reference_holds_the_port_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for name in CELLS:
        cell = _cell(tiny, name)
        seed = sched.cluster_seed(SEED, 2)
        res = _cluster(cell, seed, torch.device("cuda"))
        assert _judge(cell, seed, res)[1] == {k: 0 for k in oracle.CHECKS}
