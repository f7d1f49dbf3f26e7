"""Flight recorder: a persistent per-round telemetry timeline.

Port of ``corro_sim/obs/flight.py`` (host-side, no tensors): the
convergence analysis is curve-shaped, so ``run_sim`` keeps a durable
per-round record of every step metric beside its sparse annotations.

:class:`FlightRecorder` is a bounded, round-indexed recorder fed by
``corro_sim_torch.engine.driver.run_sim``. It keeps

- **rounds** — the full per-round step-metric vector (gap, pend_live,
  sync_pairs, SWIM events, …) in a ring of the last ``capacity`` rounds;
- **events** — sparse annotations pinned to a round (ring-wrap poison,
  repair-program switch, schedule transitions, workload events,
  convergence, pipeline discards);
- **phases** — cumulative wall-clock by host phase (setup, execute,
  drain);
- **meta** — free-form run identity (node count, seed, chunk).

The on-disk format is ND-JSON, one self-describing line per record
(``{"t": "meta"|"phase"|"round"|"event", ...}``), because a timeline
must survive the process dying mid-write: every prefix of a valid file
is a valid file. ``sink_path`` journals each record as it happens for
exactly that reason; :meth:`dump`/:meth:`load` round-trip the whole
state bit-identically, and a file written by either package loads in
the other.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading

__all__ = ["FlightRecorder"]

# Metrics whose per-round series drive the derived diagnostics.
_GAP = "gap"
_WALL = "chunk_wall_s"


def _num(v) -> float | int:
    """JSON-stable scalar: ints stay ints, everything else becomes a
    Python float (float32 widens exactly, so repr round-trips)."""
    f = float(v)
    i = int(f)
    return i if i == f else f


class FlightRecorder:
    """Bounded round-indexed telemetry recorder; thread-safe.

    ``capacity`` bounds the per-round ring (annotations and phases are
    tiny and bounded separately); ``sink_path`` additionally journals
    every record to an ND-JSON file as it is recorded, so a killed run
    still leaves the curve up to its last completed chunk.
    """

    def __init__(
        self,
        capacity: int = 65536,
        sink_path: str | None = None,
        meta: dict | None = None,
    ):
        self.capacity = int(capacity)
        self._rounds: collections.deque = collections.deque(
            maxlen=self.capacity
        )  # (round, {metric: number})
        self._events: collections.deque = collections.deque(maxlen=4096)
        self._phases: dict[str, float] = {}
        self._meta: dict = dict(meta or {})
        self._lock = threading.Lock()
        self._sink = None
        self._sink_path = sink_path
        if sink_path:
            self._open_sink(sink_path)

    @property
    def sink_path(self) -> str | None:
        return self._sink_path

    @property
    def meta(self) -> dict:
        """The run metadata (driver, nodes, scenario/workload specs…)."""
        with self._lock:
            return dict(self._meta)

    # ------------------------------------------------------------ recording
    def set_meta(self, **kw) -> None:
        with self._lock:
            self._meta.update(kw)
            self._journal({"t": "meta", **{k: kw[k] for k in kw}})

    def record_rounds(self, start_round: int, metrics: dict) -> None:
        """Fold a chunk of per-round metric vectors into the timeline.

        ``metrics``: name -> scalar or (k,) array; round ``start_round``
        is the first round the chunk covers (0-based)."""
        names = sorted(metrics)
        cols = []
        k = 1
        for n in names:
            v = metrics[n]
            row = (
                [_num(x) for x in v]
                if getattr(v, "ndim", 0) or isinstance(v, (list, tuple))
                else [_num(v)]
            )
            k = max(k, len(row))
            cols.append(row)
        with self._lock:
            for t in range(k):
                m = {
                    n: col[t] if len(col) > 1 else col[0]
                    for n, col in zip(names, cols)
                }
                rec = (int(start_round) + t, m)
                self._rounds.append(rec)
                self._journal({"t": "round", "r": rec[0], "m": m})

    def annotate(self, round_idx: int, name: str, **attrs) -> None:
        """Pin a sparse event (poison, program switch, schedule edge) to
        a round."""
        with self._lock:
            ev = {"r": int(round_idx), "name": name, "attrs": attrs}
            self._events.append(ev)
            self._journal({"t": "event", **ev})

    def events(self, name: str | None = None) -> list[dict]:
        """Annotation events (optionally filtered by name), oldest
        first. The event ring is bounded (maxlen 4096): counts derived
        from this are of RETAINED events — a very long, busy run may
        have evicted early ones."""
        with self._lock:
            return [
                dict(e) for e in self._events
                if name is None or e["name"] == name
            ]

    def record_phase(self, name: str, seconds: float) -> None:
        """Accumulate host wall-clock into a named phase bucket."""
        with self._lock:
            self._phases[name] = self._phases.get(name, 0.0) + float(seconds)
            self._journal(
                {"t": "phase", "name": name, "s": self._phases[name]}
            )

    # ----------------------------------------------------------- journaling
    def attach_sink(self, path: str) -> None:
        """Start journaling to ``path`` (truncates; writes current state
        first so the file is always a complete snapshot + live tail)."""
        with self._lock:
            self._open_sink(path)
            if self._sink is None:  # unwritable journal must not kill
                return  # the run it documents
            try:
                for line in self._lines_locked():
                    self._sink.write(line + "\n")
                self._sink.flush()
            except (OSError, ValueError):
                self._sink = None

    @property
    def sink_active(self) -> bool:
        """Whether the journal is still being written (False after
        close(), after a write error, or when the path never opened)."""
        return self._sink is not None

    def _open_sink(self, path: str) -> None:
        try:
            self._sink = open(path, "w")
            self._sink_path = path
        except OSError:
            # a broken journal must never kill the run it documents
            self._sink = None

    def _journal(self, obj: dict) -> None:
        if self._sink is None:
            return
        try:
            self._sink.write(json.dumps(obj, sort_keys=True) + "\n")
            self._sink.flush()
        except (OSError, ValueError):
            self._sink = None

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
                self._sink = None

    # ------------------------------------------------------- export / load
    def _lines_locked(self) -> list[str]:
        out = []
        if self._meta:
            out.append(json.dumps({"t": "meta", **self._meta},
                                  sort_keys=True))
        for name in sorted(self._phases):
            out.append(json.dumps(
                {"t": "phase", "name": name, "s": self._phases[name]},
                sort_keys=True,
            ))
        for r, m in self._rounds:
            out.append(json.dumps({"t": "round", "r": r, "m": m},
                                  sort_keys=True))
        for ev in self._events:
            out.append(json.dumps({"t": "event", **ev}, sort_keys=True))
        return out

    def to_ndjson(self) -> str:
        with self._lock:
            return "\n".join(self._lines_locked()) + "\n"

    def dump(self, path: str) -> None:
        """Atomic full export (write-then-rename)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_ndjson())
        os.replace(tmp, path)

    def ingest_ndjson(self, path_or_lines) -> None:
        """Replay a prior run's exported timeline into this recorder: its
        rounds/events/phases land ahead of anything this run records
        (and journal to the active sink), meta merges with THIS run's
        keys winning. Call before recording any new rounds so the
        stitched timeline stays round-ordered."""
        other = FlightRecorder.load(path_or_lines)
        with self._lock:
            for k, v in other._meta.items():
                self._meta.setdefault(k, v)
            for name, s in other._phases.items():
                # phase walls accumulate across the kill boundary: the
                # stitched record reports TOTAL compile/execute wall
                self._phases[name] = self._phases.get(name, 0.0) + s
                self._journal(
                    {"t": "phase", "name": name, "s": self._phases[name]}
                )
            for rec in other._rounds:
                self._rounds.append(rec)
                self._journal({"t": "round", "r": rec[0], "m": rec[1]})
            for ev in other._events:
                self._events.append(ev)
                self._journal({"t": "event", **ev})

    @classmethod
    def load(cls, path_or_lines) -> "FlightRecorder":
        """Rebuild a recorder from an ND-JSON export or journal. Accepts
        a path or an iterable of lines; tolerates a torn final line (the
        mid-write crash case the journal exists for)."""
        if isinstance(path_or_lines, str):
            with open(path_or_lines) as f:
                lines = f.read().splitlines()
        else:
            lines = list(path_or_lines)
        rec = cls()
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail of a killed run
            if not isinstance(obj, dict):
                continue  # a JSON line that is not a journal record
            t = obj.get("t")
            if t == "meta":
                rec._meta.update(
                    {k: v for k, v in obj.items() if k != "t"}
                )
            elif t == "phase":
                rec._phases[obj["name"]] = float(obj["s"])
            elif t == "round":
                rec._rounds.append((int(obj["r"]), obj["m"]))
            elif t == "event":
                rec._events.append({
                    "r": int(obj["r"]),
                    "name": obj["name"],
                    "attrs": obj.get("attrs", {}),
                })
        return rec

    # --------------------------------------------------------- diagnostics
    def series(self, name: str) -> tuple[list[int], list[float]]:
        """(rounds, values) for one metric across the recorded window."""
        with self._lock:
            rs, vs = [], []
            for r, m in self._rounds:
                if name in m:
                    rs.append(r)
                    vs.append(float(m[name]))
            return rs, vs

    def diagnostics(self) -> dict:
        """Derived convergence diagnostics off the recorded gap curve.

        - ``converged_round``: first round of the trailing gap==0 run
          (None while the final gap is nonzero);
        - ``gap_half_life_rounds``: ln2 / decay-rate from a log-linear
          fit over the gap's decaying tail (peak -> convergence) — the
          gossip mixing rate constant;
        - ``epidemic_window_rounds``: rounds the gap spends above 10% of
          its peak — the width of the bulk-propagation window;
        - ``wall_s_by_phase`` + per-runner chunk-wall split.
        """
        rs, gaps = self.series(_GAP)
        with self._lock:
            n_rounds = len(self._rounds)
            first_r = self._rounds[0][0] if self._rounds else None
            last_r = self._rounds[-1][0] if self._rounds else None
            phases = dict(self._phases)
            events = list(self._events)
        out: dict = {
            "rounds_recorded": n_rounds,
            "first_round": first_r,
            "last_round": last_r,
            "events_recorded": len(events),
            "wall_s_by_phase": {
                k: round(v, 6) for k, v in sorted(phases.items())
            },
            "converged_round": None,
            "gap_half_life_rounds": None,
            "epidemic_window_rounds": None,
            "peak_gap": None,
            "final_gap": None,
        }
        runner_wall = self._runner_wall(events)
        if runner_wall:
            out["chunk_wall_s_by_runner"] = runner_wall
        # chunk-pipeline summary (engine/driver.py pipelined dispatch):
        # overlap ratio, speculation counts and the fetch-wait wall ride
        # the run's final "pipeline" annotation
        pipe = next(
            (e for e in reversed(events) if e["name"] == "pipeline"), None
        )
        if pipe is not None:
            out["pipeline"] = dict(pipe["attrs"])
        if not gaps:
            return out
        out["final_gap"] = gaps[-1]
        peak = max(gaps)
        out["peak_gap"] = peak
        poisoned = any(e["name"] == "log_wrapped" for e in events)
        out["poisoned"] = poisoned
        if gaps[-1] == 0.0 and not poisoned:
            i = len(gaps) - 1
            while i > 0 and gaps[i - 1] == 0.0:
                i -= 1
            out["converged_round"] = rs[i]
        if peak > 0:
            thr = 0.1 * peak
            above = [r for r, g in zip(rs, gaps) if g > thr]
            if above:
                out["epidemic_window_rounds"] = above[-1] - above[0] + 1
            out["gap_half_life_rounds"] = self._half_life(rs, gaps, peak)
        return out

    @staticmethod
    def _half_life(rs, gaps, peak) -> float | None:
        """ln2 / slope of ln(gap) over the decaying tail after the peak."""
        start = gaps.index(peak)
        xs = [float(r) for r, g in zip(rs[start:], gaps[start:]) if g > 0]
        ys = [math.log(g) for g in gaps[start:] if g > 0]
        if len(xs) < 2:
            return None
        n = len(xs)
        mx = sum(xs) / n
        my = sum(ys) / n
        sxx = sum((x - mx) ** 2 for x in xs)
        if sxx == 0:
            return None
        slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
        if slope >= 0:
            return None  # not decaying — no half-life to report
        return round(math.log(2.0) / -slope, 3)

    @staticmethod
    def _runner_wall(events) -> dict:
        walls: dict[str, float] = {}
        for e in events:
            if e["name"] == "chunk":
                runner = e["attrs"].get("runner", "full")
                walls[runner] = walls.get(runner, 0.0) + float(
                    e["attrs"].get("wall_s", 0.0)
                )
        return {k: round(v, 6) for k, v in sorted(walls.items())}

    # ------------------------------------------------------------- reading
    def timeline(self, last_rounds: int | None = None) -> dict:
        """Full JSON view: meta, diagnostics, rounds and events."""
        with self._lock:
            rounds = list(self._rounds)
            events = list(self._events)
            meta = dict(self._meta)
        if last_rounds is not None:
            rounds = rounds[-int(last_rounds):]
        return {
            "meta": meta,
            "diagnostics": self.diagnostics(),
            "rounds": [{"r": r, "m": m} for r, m in rounds],
            "events": events,
        }
