"""Host-runtime helpers: shutdown, counted tasks, backoff, lock tracking,
the atomic JSON dump, the asynchronous device-to-host fetch, the
non-blocking upload and the host copy of a state leaf.

``Tripwire``, ``spawn_counted`` with its drain barrier, ``Backoff``,
``BackoffClock``, ``LockRegistry`` and ``atomic_json_dump`` are
``corro_sim/utils/runtime.py``'s: the reference's ``tripwire``,
``spawn`` and ``backoff`` crates over threads, and its labelled lock
registry (``corro-types/src/agent.rs:890-1099``). The JAX
package's ``start_async_fetch`` starts ``copy_to_host_async`` on each
buffer; here :func:`start_async_fetch` enqueues a copy of each tensor
into pinned host memory with ``non_blocking=True`` and records a CUDA
event behind it, and :meth:`AsyncFetch.resolve` waits on that event
alone (the host never waits for work queued after the copy). On the CPU
it is a plain copy.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import signal
import threading
import time

import numpy as np
import torch


class Tripwire:
    """Cooperative shutdown signal shared by the host-side loops:
    ``tripped`` flips once and waiters unblock at once. Optionally wired
    to SIGTERM/SIGINT (the reference's ``Tripwire::new_signals``)."""

    def __init__(self):
        self._event = threading.Event()
        self._callbacks: list = []
        self._lock = threading.Lock()

    @classmethod
    def new_signals(cls) -> "Tripwire":
        tw = cls()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, lambda *_: tw.trip())
            except ValueError:
                # not on the main thread: cooperative trip only
                break
        return tw

    @property
    def tripped(self) -> bool:
        return self._event.is_set()

    def trip(self) -> None:
        with self._lock:
            already = self._event.is_set()
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        if not already:
            for cb in callbacks:
                cb()

    def on_trip(self, callback) -> None:
        """Run ``callback`` once when tripped (at once if already)."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(callback)
                return
        callback()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def sleep(self, seconds: float) -> bool:
        """Preemptible sleep: True when the trip interrupted it."""
        return self._event.wait(seconds)


# counted task spawn (the reference's ``spawn`` crate)
_PENDING = 0
_PENDING_LOCK = threading.Lock()
_PENDING_ZERO = threading.Condition(_PENDING_LOCK)


def spawn_counted(fn, *args, name: str | None = None,
                  **kwargs) -> threading.Thread:
    """Run ``fn`` on a daemon thread tracked by the global pending
    counter."""
    global _PENDING
    with _PENDING_LOCK:
        _PENDING += 1

    def run():
        global _PENDING
        try:
            fn(*args, **kwargs)
        finally:
            with _PENDING_LOCK:
                _PENDING -= 1
                if _PENDING == 0:
                    _PENDING_ZERO.notify_all()

    t = threading.Thread(target=run, daemon=True, name=name or fn.__name__)
    t.start()
    return t


def pending_handles() -> int:
    with _PENDING_LOCK:
        return _PENDING


def wait_for_all_pending_handles(timeout: float | None = None) -> bool:
    """Drain-on-shutdown barrier: block until every counted task has
    finished; False when ``timeout`` ran out first."""
    deadline = None if timeout is None else time.monotonic() + timeout
    with _PENDING_LOCK:
        while _PENDING > 0:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
            _PENDING_ZERO.wait(remaining)
    return True


class Backoff:
    """Iterator of sleep durations, exponential within [lo, hi] and
    optionally jittered: ``iter(Backoff(1, 15))`` yields 1, 2, 4, 8, 15,
    15, ... (the reference's sync-loop cadence, ``agent/util.rs:345-348``).
    """

    def __init__(self, lo: float, hi: float, factor: float = 2.0,
                 jitter: float = 0.0, max_retries: int | None = None):
        if not (lo > 0 and hi >= lo and factor > 1.0):
            raise ValueError("Backoff needs 0 < lo <= hi and factor > 1")
        self.lo, self.hi, self.factor = lo, hi, factor
        self.jitter = jitter
        self.max_retries = max_retries

    def __iter__(self):
        it = (min(self.lo * self.factor ** i, self.hi)
              for i in itertools.count())
        if self.max_retries is not None:
            it = itertools.islice(it, self.max_retries)
        if self.jitter:
            it = (d * (1.0 + random.uniform(-self.jitter, self.jitter))
                  for d in it)
        return it

    def reset_after(self, delay: float) -> "BackoffClock":
        return BackoffClock(self, delay)


class BackoffClock:
    """Stateful view of a :class:`Backoff`: :meth:`next_delay` advances,
    and a quiet period longer than ``reset_after`` starts it over."""

    def __init__(self, backoff: Backoff, reset_after: float):
        self._b = backoff
        self._reset_after = reset_after
        self._it = iter(backoff)
        self._last = time.monotonic()

    def next_delay(self) -> float:
        now = time.monotonic()
        if now - self._last > self._reset_after:
            self._it = iter(self._b)
        self._last = now
        return next(self._it)


class LockRegistry:
    """Labelled lock tracking, for diagnosing deadlocks: every
    acquisition through :meth:`tracked` is registered with a label, a
    kind and its start time, and :meth:`snapshot` lists them, longest
    held first (the admin ``locks --top N`` command)."""

    def __init__(self, histograms=None):
        self.histograms = histograms  # cluster-scoped wait histograms
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._active: dict[int, dict] = {}

    def tracked(self, inner_lock, label: str, kind: str = "lock"):
        return _TrackedAcquire(self, inner_lock, label, kind)

    def _register(self, label: str, kind: str, state: str) -> int:
        with self._lock:
            lid = next(self._ids)
            self._active[lid] = {"id": lid, "label": label, "kind": kind,
                                 "state": state,
                                 "started": time.monotonic()}
            return lid

    def _set_state(self, lid: int, state: str) -> None:
        with self._lock:
            if lid in self._active:
                self._active[lid]["state"] = state

    def _unregister(self, lid: int) -> None:
        with self._lock:
            self._active.pop(lid, None)

    def snapshot(self, top: int | None = None) -> list[dict]:
        now = time.monotonic()
        with self._lock:
            rows = [{**e, "held_for": now - e["started"]}
                    for e in self._active.values()]
        rows.sort(key=lambda e: -e["held_for"])
        return rows[:top] if top else rows


class _TrackedAcquire:
    def __init__(self, registry: LockRegistry, lock, label: str, kind: str):
        self._reg = registry
        self._lock = lock
        self._label = label
        self._kind = kind
        self._lid = None

    def __enter__(self):
        self._lid = self._reg._register(self._label, self._kind,
                                        "acquiring")
        t0 = time.perf_counter()
        self._lock.acquire()
        wait = time.perf_counter() - t0
        self._reg._set_state(self._lid, "locked")
        # the lock-wait histograms (corro.sqlite.write_permit.
        # acquisition.seconds, corro.sqlite.pool.queue.seconds), in the
        # cluster's registry when the LockRegistry belongs to one
        if self._reg.histograms is not None:
            histograms = self._reg.histograms
        else:
            from corro_sim_torch.utils.metrics import histograms
        write = self._kind == "write"
        histograms.observe(
            "corro_sqlite_write_permit_acquisition_seconds" if write
            else "corro_sqlite_pool_queue_seconds",
            wait,
            help_=("write-lock acquisition wait "
                   "(corro.sqlite.write_permit.acquisition.seconds)"
                   if write else "read-path lock queue wait "
                   "(corro.sqlite.pool.queue.seconds)"),
        )
        return self

    def __exit__(self, *exc):
        self._lock.release()
        self._reg._unregister(self._lid)
        return False


def atomic_json_dump(path: str, obj, indent: int | None = None) -> bool:
    """Write-then-rename JSON dump, so readers never see a torn file.
    Never raises: returns False on OSError (an artifact write must not
    kill the run it documents)."""
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent)
        os.replace(tmp, path)
        return True
    except OSError:
        return False


class AsyncFetch:
    """Device-to-host copies in flight; :meth:`resolve` returns them as
    numpy arrays."""

    def __init__(self, tensors):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self._host = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors
            ]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.detach().clone() for t in tensors]

    def ready(self) -> bool:
        """Whether the copies have landed (never waits)."""
        return self._event is None or self._event.query()

    def resolve(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def start_async_fetch(*tensors) -> AsyncFetch:
    """Begin copying ``tensors`` to the host without blocking."""
    return AsyncFetch(tensors)


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, without waiting for the card: through
    pinned memory with ``non_blocking`` (a pageable copy would first
    drain the card's queue)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def host_array(x) -> np.ndarray:
    """A state leaf as a numpy array: a tensor on any device is copied to
    the host, anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
