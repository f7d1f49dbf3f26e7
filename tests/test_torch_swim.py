"""Parity, SWIM module by module: corro_sim_torch.membership against
corro_sim.membership on the CPU.

Both sides get the same numbers, drawn from a seeded numpy generator,
and the same keys; every belief plane, view and metric must be equal
after every tick (tolerance: exact — SWIM is integer arithmetic). The
scenario (modeled on tests/test_swim.py) has dead nodes, a partition
window and a node that comes back, so probe failures, suspicion, the
timeout to DOWN, the announce and refutation all occur. Two whole-run
checks close the file: a narrow run across round 256 against the JAX
package, and the port against the digests of the JAX package's runs
that chip_smoke.py holds the card to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _assert_runs_equal, north_star_swim

from corro_sim.config import SimConfig
from corro_sim.engine.driver import Schedule as RefSchedule
from corro_sim.engine.driver import run_sim as ref_run_sim
from corro_sim.engine.state import init_state as ref_init_state
from corro_sim.membership import swim as r_swim
from corro_sim.membership import swim_window as r_win
from corro_sim_torch import prng
from corro_sim_torch.config import sim_config_from_dict
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.engine.step import _reachable_fn
from corro_sim_torch.membership import swim as p_swim
from corro_sim_torch.membership import swim_window as p_win
from corro_sim_torch.profile_slice import (
    DIGEST_RUN_ARGS,
    DIGESTS,
    SWIM_DIGEST_CASES,
    digest_config,
    run_digest,
    slice_schedule,
)

N = 16
START = 250  # narrow since is mod 2^8: a run of ticks crosses round 256


def _cfg(**kw):
    # swim_interval 3 against the announce interval 4: the announce fires
    # on three ticks of four (the tick cadence itself is the step's)
    return SimConfig(num_nodes=N, swim_enabled=True, swim_suspect_rounds=3,
                     swim_interval=3, **kw)


def _port(cfg):
    return sim_config_from_dict(dataclasses.asdict(cfg))


def _truth(t: int):
    """Ground truth of tick ``t``: node 3 dead throughout, node 9 dead
    for the first 10 ticks, the upper half cut off on ticks 4-11."""
    alive = np.ones(N, bool)
    alive[3] = False
    if t < 10:
        alive[9] = False
    part = np.zeros(N, np.int32)
    if 4 <= t < 12:
        part[N // 2:] = 1
    return alive, part


def _random_plane(rng, wide: bool):
    """A packed plane mid-protocol: mostly ALIVE, some SUSPECT and DOWN
    beliefs at low incarnations, suspicion clocks spread over the
    field."""
    status = rng.choice(3, size=(N, N), p=[0.7, 0.2, 0.1])
    inc = rng.integers(0, 4, size=(N, N))
    since = rng.integers(0, 1 << (16 if wide else 8), size=(N, N))
    return status, inc, since


def _ref_reach(alive, part):
    def reach(src, dst):
        return alive[src] & alive[dst] & (part[src] == part[dst])

    return reach


@pytest.fixture(scope="module")
def ref_tick():
    """jit-compiled reference ticks, one program per config and layout."""
    cache = {}

    def tick(cfg, windowed, sw, key, alive, part, r):
        fn = cache.get((cfg, windowed))
        if fn is None:
            step = r_win.swim_window_step if windowed else r_swim.swim_step

            def body(sw, key, alive, part, r):
                return step(cfg, sw, key, alive, _ref_reach(alive, part), r)

            fn = cache[(cfg, windowed)] = jax.jit(body)
        return fn(sw, key, jnp.asarray(alive), jnp.asarray(part),
                  jnp.int32(r))

    return tick


def _assert_metrics(mr, mp):
    assert set(mr) == set(mp)
    for k in mr:
        assert int(mr[k]) == int(mp[k]), k


def _run_ticks(ref_tick, cfg, windowed, ref_sw, port_sw, ticks, start):
    """Tick both sides in lockstep and compare after every tick; returns
    the per-tick metrics and the two final states."""
    pcfg = _port(cfg)
    seen = []
    for t in range(ticks):
        key = prng.fold_in(prng.PRNGKey(7), t)
        alive, part = _truth(t)
        r = start + t
        ref_sw, mr = ref_tick(cfg, windowed, ref_sw, jnp.asarray(key),
                              alive, part, r)
        at, pt = torch.as_tensor(alive), torch.as_tensor(part)
        step = p_win.swim_window_step if windowed else p_swim.swim_step
        port_sw, mp = step(pcfg, port_sw, key, at, _reachable_fn(at, pt), r)
        _assert_states(ref_sw, port_sw, windowed)
        _assert_metrics(mr, mp)
        seen.append({k: int(v) for k, v in mr.items()})
    return seen, ref_sw, port_sw


def _assert_states(ref_sw, port_sw, windowed):
    fields = ("member", "belief", "cursor") if windowed else ("p",)
    for f in fields:
        want = np.asarray(getattr(ref_sw, f))
        got = getattr(port_sw, f).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f)
        assert want.min(initial=0) >= 0 and got.min(initial=0) >= 0


def _plane_pair(cfg, rng, random_start: bool):
    wide = not cfg.narrow_state
    ref = r_swim.make_swim_state(N, narrow=cfg.narrow_state)
    if random_start:
        status, inc, since = _random_plane(rng, wide)
        ref = ref.replace(p=r_swim.pack_swim(
            status, inc, since, dtype=ref.p.dtype))
    dt = p_swim.belief_dtype(cfg.narrow_state)
    port = p_swim.SwimState(p=torch.as_tensor(
        np.asarray(ref.p).astype(np.int64)).to(dt))
    return ref, port


@pytest.mark.parametrize("ticks", [1, 24], ids=["one_tick", "24_ticks"])
@pytest.mark.parametrize("payload", [6, 64], ids=["bounded", "full_view"])
@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "wide"])
def test_swim_step_bit_identical(ref_tick, narrow, payload, ticks):
    cfg = _cfg(narrow_state=narrow, swim_payload_members=payload)
    rng = np.random.default_rng(3)
    ref, port = _plane_pair(cfg, rng, random_start=ticks == 1)
    seen, ref, port = _run_ticks(ref_tick, cfg, False, ref, port, ticks,
                                 START)
    if ticks > 1:
        # the scenario reached every branch of the automaton
        assert max(m["swim_probe_failures"] for m in seen) > 0
        assert max(m["swim_suspects"] for m in seen) > 0
        assert max(m["swim_down"] for m in seen) > 0
        assert int(np.asarray(ref.inc).diagonal()[9]) > 0  # refuted
        assert (np.asarray(ref.status)[:, 3][np.arange(N) != 3]
                == int(r_swim.DOWN)).all()


@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "wide"])
def test_swim_step_views(narrow):
    """The unpacked views, ``view_alive`` and ``down_belief_matrix``
    decode a random plane as the reference does."""
    rng = np.random.default_rng(5)
    status, inc, since = _random_plane(rng, not narrow)
    dt = r_swim.belief_dtype(narrow)
    ref = r_swim.SwimState(p=r_swim.pack_swim(status, inc, since, dtype=dt))
    port = p_swim.SwimState(p=p_swim.pack_swim(
        status, inc, since, p_swim.belief_dtype(narrow)))
    np.testing.assert_array_equal(
        port.p.numpy(), np.asarray(ref.p).astype(port.p.numpy().dtype))
    for view in ("status", "inc", "since"):
        want = np.asarray(getattr(ref, view))
        got = getattr(port, view).numpy()
        assert got.dtype == want.dtype, view
        np.testing.assert_array_equal(got, want, err_msg=view)
    np.testing.assert_array_equal(p_swim.view_alive(port).numpy(),
                                  np.asarray(r_swim.view_alive(ref)))
    np.testing.assert_array_equal(p_swim.down_belief_matrix(port, N),
                                  r_swim.down_belief_matrix(ref, N))


@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "wide"])
def test_refutation_saturates_at_inc_max(ref_tick, narrow):
    """A node suspected at the incarnation cap refutes to ALIVE at the
    cap, not past it (tests/test_narrow_state.py's saturation case, run
    through a whole tick), and the capped entry keeps its precedence."""
    cfg = _cfg(narrow_state=narrow)
    lo = p_swim.swim_layout(p_swim.belief_dtype(narrow))
    status = np.zeros((N, N), np.int64)
    inc = np.zeros((N, N), np.int64)
    inc[:, 5] = lo.inc_max - 1
    status[0, 5] = int(r_swim.DOWN)
    status[5, 5] = int(r_swim.SUSPECT)  # suspected at the cap
    inc[5, 5] = lo.inc_max
    status[6, 6] = int(r_swim.DOWN)  # one below the cap
    inc[6, 6] = lo.inc_max - 1
    dt = r_swim.belief_dtype(narrow)
    ref = r_swim.SwimState(p=r_swim.pack_swim(status, inc, 0, dtype=dt))
    port = p_swim.SwimState(p=p_swim.pack_swim(
        status, inc, 0, p_swim.belief_dtype(narrow)))
    _, ref, port = _run_ticks(ref_tick, cfg, False, ref, port, 1, 40)
    pinc, pstat = port.inc.numpy(), port.status.numpy()
    assert pinc[5, 5] == lo.inc_max and pstat[5, 5] == p_swim.ALIVE
    assert pinc[6, 6] == lo.inc_max and pstat[6, 6] == p_swim.ALIVE


def _window_pair(cfg, seed=0):
    ref = r_win.make_swim_window_state(
        N, cfg.swim_view_size, seed=seed, narrow=cfg.narrow_state)
    port = p_win.make_swim_window_state(
        N, cfg.swim_view_size, seed, True, cfg.narrow_state, "cpu")
    return ref, port


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "wide"])
def test_make_swim_window_state(narrow, seed):
    """The bootstrap sample comes from PRNGKey(seed ^ 0x5117) on both
    sides; SWIM off gives the (1, 1) placeholder."""
    cfg = _cfg(narrow_state=narrow, swim_view_size=6)
    ref, port = _window_pair(cfg, seed)
    _assert_states(ref, port, windowed=True)
    assert port.belief.dtype == p_swim.belief_dtype(narrow)
    off = p_win.make_swim_window_state(N, 6, seed, False, narrow, "cpu")
    assert off.member.shape == (1, 1) and off.cursor.shape == (1,)


@pytest.mark.parametrize("ticks", [1, 24], ids=["one_tick", "24_ticks"])
@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "wide"])
def test_swim_window_step_bit_identical(ref_tick, narrow, ticks):
    cfg = _cfg(narrow_state=narrow, swim_view_size=8,
               swim_payload_members=4)
    ref, port = _window_pair(cfg)
    if ticks == 1:
        # a view mid-protocol: random beliefs in the tracked slots
        rng = np.random.default_rng(9)
        status, inc, since = _random_plane(rng, not narrow)
        packed = r_swim.pack_swim(status[:, :8], inc[:, :8], since[:, :8],
                                  dtype=ref.belief.dtype)
        ref = ref.replace(belief=packed)
        port = dataclasses.replace(port, belief=torch.as_tensor(
            np.asarray(packed).astype(np.int64)).to(port.belief.dtype))
    seen, ref, port = _run_ticks(ref_tick, cfg, True, ref, port, ticks,
                                 START)
    if ticks > 1:
        assert max(m["swim_probe_failures"] for m in seen) > 0
        assert max(m["swim_suspects"] for m in seen) > 0
        assert max(m["swim_down"] for m in seen) > 0
        assert int(np.asarray(ref.self_inc).max()) > 0  # someone refuted


@pytest.mark.parametrize("narrow", [True, False], ids=["narrow", "wide"])
def test_window_views(ref_tick, narrow):
    """``membership_view``'s windowed test, ``view_alive_dense`` and
    ``down_belief_matrix`` on a windowed state after a few ticks."""
    cfg = _cfg(narrow_state=narrow, swim_view_size=8,
               swim_payload_members=4)
    ref, port = _window_pair(cfg)
    _, ref, port = _run_ticks(ref_tick, cfg, True, ref, port, 10, 0)
    np.testing.assert_array_equal(p_win.view_alive_dense(port).numpy(),
                                  np.asarray(r_win.view_alive_dense(ref)))
    np.testing.assert_array_equal(p_swim.down_belief_matrix(port, N),
                                  r_swim.down_belief_matrix(ref, N))
    view = p_win.membership_view(_port(cfg), port, N)
    rng = np.random.default_rng(2)
    src = rng.integers(0, N, (5, 7)).astype(np.int32)
    dst = rng.integers(0, N, (5, 7)).astype(np.int32)
    want = r_win.membership_view(cfg, ref, N)(jnp.asarray(src),
                                               jnp.asarray(dst))
    np.testing.assert_array_equal(
        view(torch.as_tensor(src), torch.as_tensor(dst)).numpy(),
        np.asarray(want))
    for swim_on, view_size in ((False, 0), (False, 8), (True, 0)):
        c = dataclasses.replace(cfg, swim_enabled=swim_on,
                                swim_view_size=view_size)
        sw = (p_win.make_swim_window_state(N, view_size, 0, swim_on, narrow,
                                           "cpu") if view_size else
              p_swim.make_swim_state(N, swim_on, narrow, "cpu"))
        got = p_win.membership_view(_port(c), sw, N)
        if swim_on:
            assert got.shape == (N, N) and bool(got.all())
        else:
            assert got.shape == (1, N) and bool(got.all())


def test_window_merge_duplicate_slots_later_lane_wins():
    """More fresh entries than ``k - 1`` wrap the insertion cursor onto
    a slot an earlier lane of the row also fills. The JAX package leaves
    that write's winner unspecified (so no parity test reaches it); the
    port applies fresh lanes in payload order: the later lane wins."""
    k = 3
    member = torch.tensor([[0, -1, -1], [1, 2, 3], [2, -1, -1],
                           [3, -1, -1]], dtype=torch.int32)
    belief = torch.tensor([[0, 0, 0], [0, 1, 2], [0, 0, 0], [0, 0, 0]],
                          dtype=torch.int32)
    st = p_win.SwimWindowState(member=member, belief=belief,
                               cursor=torch.ones(4, dtype=torch.int32))
    # node 0 pulls node 1's whole view: members 1, 2, 3 are all fresh
    peer = torch.tensor([1, 1, 2, 3], dtype=torch.int32)
    ok = torch.tensor([True, False, False, False])
    out = p_win._merge_block(st, peer, ok, torch.zeros(4, dtype=torch.int32),
                             k)
    # lanes 0 and 2 (members 1 and 3) both map to slot 1: member 3 wins
    assert out.member[0].tolist() == [0, 3, 2]
    assert out.belief[0].tolist() == [0, 2, 1]
    assert out.cursor.tolist() == [2, 1, 1, 1]
    assert torch.equal(out.member[1:], member[1:])


def test_swim_share_counts_host_launches_inside_host_ranges():
    """profile_slice's SWIM share of launches counts the launch calls the
    host made inside each tick's host-side range, not inside the range's
    device-side span (which covers later host work too)."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from corro_sim_torch.profile_slice import _launches_in

    def ev(name, dev, start, end):
        return SimpleNamespace(
            name=name, device_type=dev,
            time_range=SimpleNamespace(start=start, end=end))

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        ev("swim_tick", cpu, 10, 20),
        ev("swim_tick", gpu, 15, 60),  # the device-side span: not counted
        *(ev("cudaLaunchKernel", cpu, t, t + 1) for t in (5, 11, 19, 30, 50)),
        ev("cudaLaunchKernelExC", cpu, 12, 13),
        ev("vectorized_elementwise_kernel", gpu, 16, 17),
    ]
    assert _launches_in(events, "swim_tick") == (3, 6)


def _flapping(rounds: int, n: int) -> np.ndarray:
    """(rounds, n) ground truth: node 5 down on odd 16-round periods and
    node 11 on periods shifted by 8, up to round 300."""
    r = np.arange(rounds)[:, None]
    alive = np.ones((rounds, n), bool)
    alive[:, 5] = ((r[:, 0] // 16) % 2 == 0) | (r[:, 0] >= 300)
    alive[:, 11] = (((r[:, 0] + 8) // 16) % 2 == 0) | (r[:, 0] >= 300)
    return alive


def test_since_wrap_past_round_256_bit_identical():
    """A narrow run of 320 rounds at 16 nodes: the 8-bit suspicion clock
    wraps at round 256 with suspicions live on both sides of it, and the
    repair step ticks SWIM through the tail."""
    cfg = dataclasses.replace(
        north_star_swim(interval=1), num_nodes=16, num_rows=16,
        sync_actor_topk=8, sync_req_actors=8, sync_need_sample=8,
        write_rate=0.3,
    )
    kw = dict(max_rounds=320, chunk=16, seed=0, min_rounds=310,
              stop_on_convergence=False)
    alive = _flapping(320, 16)
    ref = ref_run_sim(cfg, ref_init_state(cfg, seed=0),
                      RefSchedule(write_rounds=8, alive=alive), **kw)
    pcfg = sim_config_from_dict(dataclasses.asdict(cfg))
    got = run_sim(pcfg, init_state(pcfg, seed=0, device="cpu"),
                  Schedule(write_rounds=8, alive=alive), device="cpu", **kw)
    suspects = ref.metrics["swim_suspects"]
    assert ref.rounds == 320 and ref.repair_chunks > 0
    assert suspects[:256].sum() > 0 and suspects[256:].sum() > 0
    _assert_runs_equal(ref, got)


@pytest.mark.parametrize("case", sorted(SWIM_DIGEST_CASES))
def test_swim_digest(case):
    """The port on the CPU reproduces the digests of the JAX package's
    runs that chip_smoke.py holds the card to."""
    cfg = digest_config(case)
    res = run_sim(cfg, init_state(cfg, seed=0, device="cpu"),
                  slice_schedule(), device="cpu", **DIGEST_RUN_ARGS)
    assert run_digest(state_to_numpy(res.state), res.metrics) == DIGESTS[case]
