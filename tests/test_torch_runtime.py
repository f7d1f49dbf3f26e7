"""Parity of the port's host-runtime primitives (corro_sim_torch.utils.
runtime) with the JAX package's: ``Tripwire``, ``spawn_counted`` with its
drain barrier, ``Backoff`` and ``BackoffClock``, and ``LockRegistry``.
Each case runs once per module and the two must observe the same thing
(tolerance: exact; the one difference by design is that the port's
``Backoff`` refuses bad bounds with ValueError where the JAX package
asserts)."""

import threading
import time

import pytest

import corro_sim.utils.runtime as r_runtime
import corro_sim_torch.utils.runtime as p_runtime
from corro_sim.utils.metrics import HistogramRegistry as RHistograms
from corro_sim_torch.utils.metrics import HistogramRegistry as PHistograms

MODULES = pytest.mark.parametrize(
    "rt", [r_runtime, p_runtime], ids=["ref", "port"])


def tripwire_trace(rt) -> list:
    tw = rt.Tripwire()
    seen = []
    tw.on_trip(lambda: seen.append("early"))
    before = (tw.tripped, tw.wait(0.0), tw.sleep(0.0))
    tw.trip()
    tw.trip()  # a second trip runs no callback again
    tw.on_trip(lambda: seen.append("late"))  # already tripped: at once
    return [before, tw.tripped, tw.wait(0.0), tw.sleep(5.0), seen]


def test_tripwire_matches_reference():
    assert tripwire_trace(p_runtime) == tripwire_trace(r_runtime)
    assert tripwire_trace(p_runtime) == [
        (False, False, False), True, True, True, ["early", "late"]]


def test_tripwire_wakes_a_waiting_thread():
    for rt in (r_runtime, p_runtime):
        tw = rt.Tripwire()
        woke = []
        t = threading.Thread(target=lambda: woke.append(tw.sleep(30.0)))
        t.start()
        tw.trip()
        t.join(5.0)
        assert woke == [True]


def backoff_trace(rt) -> list:
    out = [list(rt.Backoff(1, 15, max_retries=7)),
           list(rt.Backoff(0.5, 3, factor=3.0, max_retries=4))]
    it = iter(rt.Backoff(2, 100))
    out.append([next(it) for _ in range(8)])
    clock = rt.Backoff(1, 8).reset_after(0.05)
    out.append([clock.next_delay() for _ in range(5)])
    time.sleep(0.1)  # a quiet period longer than reset_after
    out.append([clock.next_delay() for _ in range(2)])
    jit = list(rt.Backoff(1, 4, jitter=0.25, max_retries=20))
    out.append([len(jit), all(0.75 * min(2 ** i, 4) <= d
                              <= 1.25 * min(2 ** i, 4)
                              for i, d in enumerate(jit))])
    return out


def test_backoff_and_clock_match_reference():
    got = backoff_trace(p_runtime)
    assert got == backoff_trace(r_runtime)
    assert got[0] == [1, 2, 4, 8, 15, 15, 15]
    assert got[3] == [1, 2, 4, 8, 8] and got[4] == [1, 2]


@pytest.mark.parametrize("bad", [(0, 1), (2, 1), (1, 2, 1.0)])
def test_backoff_refuses_bad_bounds(bad):
    with pytest.raises(AssertionError):
        r_runtime.Backoff(*bad)
    with pytest.raises(ValueError):
        p_runtime.Backoff(*bad)


@MODULES
def test_spawn_counted_and_drain_barrier(rt):
    gate = threading.Event()
    done = []
    base = rt.pending_handles()
    threads = [rt.spawn_counted(lambda i=i: (gate.wait(5.0), done.append(i)),
                                name=f"w{i}") for i in range(3)]
    assert rt.pending_handles() == base + 3
    assert [t.name for t in threads] == ["w0", "w1", "w2"]
    assert all(t.daemon for t in threads)
    assert rt.wait_for_all_pending_handles(timeout=0.05) is False
    gate.set()
    assert rt.wait_for_all_pending_handles(timeout=5.0) is True
    assert rt.pending_handles() == 0 and sorted(done) == [0, 1, 2]


def lock_trace(rt, registry_cls) -> list:
    hist = registry_cls()
    reg = rt.LockRegistry(histograms=hist)
    lock = threading.RLock()
    out = []
    with reg.tracked(lock, "execute node=0", "write"):
        with reg.tracked(lock, "query node=1", "read"):
            snap = reg.snapshot()
            out.append(sorted((e["label"], e["kind"], e["state"])
                              for e in snap))
            out.append(len(reg.snapshot(top=1)))
            out.append(all(e["held_for"] >= 0 for e in snap))
    out.append(reg.snapshot())
    out.append([
        hist.get(name).count for name in (
            "corro_sqlite_write_permit_acquisition_seconds",
            "corro_sqlite_pool_queue_seconds")])
    # a contended acquisition is listed as acquiring until it gets in
    inner = threading.Lock()
    inner.acquire()
    t = threading.Thread(
        target=lambda: reg.tracked(inner, "tick", "write").__enter__())
    t.start()
    deadline = time.monotonic() + 5.0
    while not reg.snapshot() and time.monotonic() < deadline:
        time.sleep(0.005)
    out.append([(e["label"], e["state"]) for e in reg.snapshot()])
    inner.release()
    t.join(5.0)
    out.append([(e["label"], e["state"]) for e in reg.snapshot()])
    return out


def test_lock_registry_matches_reference():
    got = lock_trace(p_runtime, PHistograms)
    assert got == lock_trace(r_runtime, RHistograms)
    assert got[0] == [("execute node=0", "write", "locked"),
                      ("query node=1", "read", "locked")]
    assert got[3] == [] and got[4] == [1, 1]
    assert got[5] == [("tick", "acquiring")]
    assert got[6] == [("tick", "locked")]
