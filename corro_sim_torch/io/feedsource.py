"""Live feed sources: the twin's tail-mode input.

Port of ``corro_sim/io/feedsource.py`` (standard library only). File-mode
replay (:func:`corro_sim_torch.engine.twin.load_feed_lines`) reads a
COMPLETED feed once; a live operator loop shadows a feed that is still
being written. This module is the boundary where every live-source
hazard is absorbed so the shadow itself stays bit-identical to file
mode (the twin's live-tail tests pin that identity):

- **torn tails** — a writer caught mid-append leaves an unterminated
  final line. Wait, don't quarantine: only ``\\n``-terminated lines are
  ever delivered, so the stream never sees a half-written changeset
  (the one-shot validator reports the same situation as ``torn_tail``,
  retryable — :data:`corro_sim_torch.io.traces.BAD_TORN_TAIL`);
- **rotation vs truncation** — detected via inode + consumed-prefix
  sha. A rotated feed (new inode under the tailed path) RE-BINDS: the
  old segment drains to EOF, then the new file is consumed from byte 0
  (or from the consumed prefix, when its prefix sha proves it is a
  superset copy of everything already delivered). A truncated feed
  (same inode, size below the consumed offset) REFUSES with
  :class:`FeedSourceError` — a tail cannot rewind committed history;
- **stalls and death** — inotify-free polling with jittered exponential
  backoff. A missing file / failing endpoint consumes the
  ``reconnect_max_s`` budget; a source that yields no new byte for
  ``idle_timeout_s`` is declared dead (``idle_timeout`` — the only
  natural exit of a live tail). Death is a STATE, not an exception:
  :meth:`FeedSource.wait_lines` returns short and the twin drains what
  it has (a resumable cursor);
- **lag bounds** — the source stops reading ahead once
  ``max_lag_lines`` undelivered lines are buffered (backpressure
  against a producer outrunning the shadow).

Every hazard counts: ``corro_twin_tail_polls_total{source}``,
``..._retries_total{source}``, ``..._rotations_total``,
``..._source_deaths_total{reason}`` (utils/metrics.py constants, the
exposition-validated families).
"""

from __future__ import annotations

import hashlib
import os
import random
import time
import urllib.error
import urllib.request

from corro_sim_torch.utils.metrics import (
    TWIN_TAIL_POLLS_HELP,
    TWIN_TAIL_POLLS_TOTAL,
    TWIN_TAIL_RETRIES_HELP,
    TWIN_TAIL_RETRIES_TOTAL,
    TWIN_TAIL_ROTATIONS_HELP,
    TWIN_TAIL_ROTATIONS_TOTAL,
    TWIN_TAIL_SOURCE_DEATHS_HELP,
    TWIN_TAIL_SOURCE_DEATHS_TOTAL,
    counters,
)

__all__ = [
    "FeedSource",
    "FeedSourceError",
    "FileTailSource",
    "HTTPWatchSource",
]

# death reasons (the corro_twin_tail_source_deaths_total label set)
DEATH_IDLE = "idle_timeout"  # source alive but silent past the budget
DEATH_GONE = "source_gone"  # file missing past the backoff budget
DEATH_RECONNECT = "reconnect_budget"  # endpoint failing past the budget
DEATH_TRUNCATED = "truncated"  # refusal — raised, never drained past


class FeedSourceError(RuntimeError):
    """A live-source REFUSAL (e.g. truncation): the feed's committed
    history moved under the tail, so continuing would silently diverge."""


class FeedSource:
    """Common live-source machinery: the poll/backoff loop, idle and
    retry budgets, death bookkeeping and the delivery buffer. Concrete
    sources implement :meth:`_poll_once` (read whatever is newly
    available into ``self._buf``)."""

    kind = "?"

    def __init__(self, poll_ms: int = 250, reconnect_max_s: float = 30.0,
                 idle_timeout_s: float = 10.0, max_lag_lines: int = 65536,
                 jitter_seed: int = 0):
        self.poll_s = max(0.001, poll_ms / 1000.0)
        self.reconnect_max_s = float(reconnect_max_s)
        self.idle_timeout_s = float(idle_timeout_s)
        self.max_lag_lines = int(max_lag_lines)
        self.dead = False
        self.death_reason: str | None = None
        self._buf: list[str] = []
        self._delay = self.poll_s
        # jitter is timing-only (results never depend on it); seeded so
        # two identical runs back off identically
        self._rng = random.Random(jitter_seed)
        self._idle_since = time.monotonic()
        self._retry_since: float | None = None
        self.stats: dict = {
            "kind": self.kind, "polls": 0, "retries": 0, "rotations": 0,
            "reconnects": 0, "lines_delivered": 0, "lag_stalls": 0,
            "torn_dropped": 0,
        }

    # ------------------------------------------------------------ facade
    @property
    def lag_lines(self) -> int:
        return len(self._buf)

    def wait_lines(self, n: int) -> list:
        """Block until ``n`` complete lines are available or the source
        is dead; returns up to ``n`` lines (fewer ONLY when dead — the
        caller's cue to final-drain and exit)."""
        while len(self._buf) < n and not self.dead:
            self._tick()
            if len(self._buf) >= n or self.dead:
                break
            time.sleep(self._delay)
        out = self._buf[:n]
        del self._buf[:n]
        self.stats["lines_delivered"] += len(out)
        return out

    def close(self) -> None:
        pass

    def report(self) -> dict:
        return {
            **{k: v for k, v in self.stats.items()},
            "dead": self.dead,
            "death_reason": self.death_reason,
            "lag_lines": self.lag_lines,
        }

    # --------------------------------------------------------- internals
    def _tick(self) -> None:
        self.stats["polls"] += 1
        counters.inc(
            TWIN_TAIL_POLLS_TOTAL, labels=f'{{source="{self.kind}"}}',
            help_=TWIN_TAIL_POLLS_HELP,
        )
        if len(self._buf) >= self.max_lag_lines:
            # backpressure: the consumer is behind, not the source —
            # don't read ahead, don't let the idle clock accrue
            self.stats["lag_stalls"] += 1
            self._idle_since = time.monotonic()
            return
        self._poll_once()
        if (
            not self.dead
            and time.monotonic() - self._idle_since > self.idle_timeout_s
        ):
            self._die(DEATH_IDLE)

    def _poll_once(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _progress(self) -> None:
        """New bytes arrived: reset the idle clock, the retry budget
        and the backoff ladder."""
        self._idle_since = time.monotonic()
        self._retry_since = None
        self._delay = self.poll_s

    def _retry(self, death_reason: str) -> None:
        """One failed attempt against a missing/failing source: climb
        the jittered exponential ladder; past the budget, die."""
        now = time.monotonic()
        if self._retry_since is None:
            self._retry_since = now
        self.stats["retries"] += 1
        counters.inc(
            TWIN_TAIL_RETRIES_TOTAL, labels=f'{{source="{self.kind}"}}',
            help_=TWIN_TAIL_RETRIES_HELP,
        )
        if now - self._retry_since > self.reconnect_max_s:
            self._die(death_reason)
            return
        cap = max(self.poll_s, self.reconnect_max_s / 4.0)
        self._delay = min(self._delay * 2.0, cap) * (
            0.5 + self._rng.random()
        )

    def _die(self, reason: str) -> None:
        if self.dead:
            return
        self.dead = True
        self.death_reason = reason
        counters.inc(
            TWIN_TAIL_SOURCE_DEATHS_TOTAL,
            labels=f'{{reason="{reason}"}}',
            help_=TWIN_TAIL_SOURCE_DEATHS_HELP,
        )


class FileTailSource(FeedSource):
    """Poll-tail a feed file (inotify-free — works on every filesystem
    the container mounts). Module docstring covers the rotation /
    truncation / torn-tail discipline."""

    kind = "file"

    def __init__(self, path: str, **kw):
        super().__init__(**kw)
        self.path = path
        self._fd = None
        self._read_bytes = 0  # bytes read from the CURRENT segment
        self._partial = b""  # tail bytes after the last newline
        self._consumed = 0  # complete-line bytes delivered, ALL segments
        self._sha = hashlib.sha256()  # over exactly those bytes

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    # --------------------------------------------------------- poll body
    def _poll_once(self) -> None:
        try:
            st = os.stat(self.path)
        except (FileNotFoundError, PermissionError):
            if self._fd is not None:
                # the path moved away (rotation in progress): drain the
                # old segment while the new file has yet to appear
                self._drain_fd()
            self._retry(DEATH_GONE)
            return
        if self._fd is None:
            self._bind(st)
            if self._fd is None:
                return
        fst = os.fstat(self._fd)
        if (st.st_ino, st.st_dev) != (fst.st_ino, fst.st_dev):
            # rotation: a NEW file under the tailed path. Finish the old
            # segment first (rename-rotation leaves it complete), then
            # re-bind to the new inode.
            self._drain_fd()
            os.close(self._fd)
            self._fd = None
            if self._partial:
                # the rotated-away segment ended torn; nothing will
                # ever complete it (wait-don't-quarantine applies only
                # while the writer can still finish the line)
                self.stats["torn_dropped"] += 1
                self._partial = b""
            self.stats["rotations"] += 1
            counters.inc(
                TWIN_TAIL_ROTATIONS_TOTAL, help_=TWIN_TAIL_ROTATIONS_HELP
            )
            self._bind(st)
            if self._fd is None:
                return
            fst = os.fstat(self._fd)
        if fst.st_size < self._read_bytes:
            # truncation on the SAME inode: committed history rewound
            self._die(DEATH_TRUNCATED)
            raise FeedSourceError(
                f"feed {self.path!r} truncated: size {fst.st_size} < "
                f"consumed offset {self._read_bytes} on the same inode "
                "— a tail cannot rewind committed history; restart the "
                "twin against the rewritten feed"
            )
        self._drain_fd()

    def _bind(self, st) -> None:
        """Open the file at ``self.path`` and pick the resume offset:
        byte 0 for a fresh segment, or the consumed prefix when the new
        file's prefix sha proves it already contains everything
        delivered (a superset copy — rotation that preserved history)."""
        try:
            fd = os.open(self.path, os.O_RDONLY)
        except OSError:
            self._retry(DEATH_GONE)
            return
        self._fd = fd
        self._partial = b""
        self._read_bytes = 0
        if 0 < self._consumed <= st.st_size:
            h = hashlib.sha256()
            left = self._consumed
            while left > 0:
                blk = os.read(fd, min(left, 1 << 20))
                if not blk:
                    break
                h.update(blk)
                left -= len(blk)
            if left == 0 and h.digest() == self._sha.copy().digest():
                self._read_bytes = self._consumed
                return
            os.lseek(fd, 0, os.SEEK_SET)

    def _drain_fd(self) -> None:
        """Read every newly appended byte; deliver only complete lines."""
        if self._fd is None:
            return
        got = False
        while True:
            blk = os.read(self._fd, 1 << 20)
            if not blk:
                break
            got = True
            self._read_bytes += len(blk)
            data = self._partial + blk
            head, sep, self._partial = data.rpartition(b"\n")
            if sep:
                for raw in (head + sep).splitlines(keepends=True):
                    self._buf.append(raw.decode("utf-8", errors="replace"))
                    self._sha.update(raw)
                    self._consumed += len(raw)
        if got:
            # any new byte — even a still-torn tail — proves the writer
            # is alive (the wait-don't-quarantine discipline)
            self._progress()

    def report(self) -> dict:
        return {
            **super().report(),
            "path": self.path,
            "consumed_bytes": self._consumed,
            "torn_tail": bool(self._partial),
        }


class HTTPWatchSource(FeedSource):
    """Watch an ND-JSON changeset endpoint (the serving side:
    ``GET /v1/changes?offset=N&limit=K`` on the JAX package's API server
    (``corro_sim/api/http.py``) — or any endpoint speaking the same shape:
    the response body carries feed lines starting at line index
    ``offset``). The cursor IS the line position: reconnects resume
    exactly where the last delivered line left off, so a dropped
    connection never duplicates or skips a changeset."""

    kind = "http"

    def __init__(self, url: str, **kw):
        super().__init__(**kw)
        self.url = url
        self._next_offset = 0  # line index the next request asks for

    def _poll_once(self) -> None:
        sep = "&" if "?" in self.url else "?"
        limit = max(1, min(4096, self.max_lag_lines - len(self._buf)))
        req = f"{self.url}{sep}offset={self._next_offset}&limit={limit}"
        timeout = max(0.5, min(self.idle_timeout_s, 10.0))
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                body = resp.read()
        except (urllib.error.URLError, OSError, TimeoutError):
            self.stats["reconnects"] += 1
            self._retry(DEATH_RECONNECT)
            return
        # the connection is alive; whether it carried NEW lines decides
        # the idle clock below
        self._retry_since = None
        self._delay = self.poll_s
        head, sep_b, tail = body.rpartition(b"\n")
        if sep_b and tail:
            # unterminated trailing fragment: not consumed — the next
            # request re-fetches from the same line offset
            body = head + sep_b
        elif not sep_b:
            body = b""  # nothing complete at all
        lines = [
            raw.decode("utf-8", errors="replace")
            for raw in body.splitlines(keepends=True)
        ]
        if lines:
            self._buf.extend(lines)
            self._next_offset += len(lines)
            self._progress()

    def report(self) -> dict:
        return {
            **super().report(),
            "url": self.url,
            "next_offset": self._next_offset,
        }
