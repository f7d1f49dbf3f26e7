"""Resilience scorecard: the numbers a chaos run is *graded* on.

Port of ``corro_sim/faults/scorecard.py`` (host numpy), reading state
leaves through ``utils/runtime.py::host_array``.
The threshold golden holds the JAX package's thresholds, beside this
module (``resilience_thresholds.json``). ``export_metrics`` (the
``corro_resilience_*`` exposition families) is not ported yet: it comes
with the metrics exposition layer.

The invariant checkers (:mod:`corro_sim_torch.faults.invariants`) say whether a
run was CORRECT; this module says how well it RECOVERED — the SWARM-style
(PAPERS.md) replication-latency-under-load report for a run where faults
and traffic overlap:

- **recovery_rounds** — scheduled heal → re-convergence (the soak
  headline, recomputed here so the scorecard is self-contained);
- **rows_lost** — cells on which any live node still disagrees with its
  partition's reference replica at the moment convergence is reported
  (0 = the fault cost nothing durable; the crash-amnesia acceptance
  criterion);
- **resync_rows** — version-applications anti-entropy had to repay to
  rebuild wiped nodes: final applied count minus the post-wipe baseline
  (zero for amnesia, the snapshot's count for stale rejoins);
- **swim_false_down / swim_flaps** — (observer, subject) belief pairs
  that marked a ground-truth-alive node DOWN, and pairs that did so
  again after recovering (failure-detector churn under stress);
- **sub_delivery** — when a workload spec is coupled: write→apply
  delivery-latency p50/p99 during the fault window vs steady state, via
  the FIFO horizontal-distance read of the cumulative offered-work vs
  completed-work curves (the batched-path analog of the live harness's
  ``corro_sub_latency_rounds``; an aggregate-flow approximation, exact
  for FIFO service — stated in the block so nobody mistakes it for a
  per-event measurement).

Wired like the invariant checker: ``run_sim(..., scorecard=
ResilienceScorecard(cfg, scenario=sc, workload=wl))`` calls
:meth:`on_chunk` between chunks and :meth:`on_converged` at the
convergence report; the driver then attaches :meth:`finalize`'s block as
``RunResult.resilience`` and annotates it into the flight record.
:func:`check_thresholds` grades a block against the threshold golden.
"""

from __future__ import annotations

import json
import os

import numpy as np

from corro_sim_torch.utils.runtime import host_array

__all__ = [
    "THRESHOLDS_PATH",
    "ResilienceScorecard",
    "check_thresholds",
    "fifo_delivery_quantiles",
    "load_thresholds",
]


def fifo_delivery_quantiles(
    applied: np.ndarray, gap: np.ndarray, lo: int, hi: int,
    first_round: int = 0,
) -> dict | None:
    """FIFO horizontal-distance latency quantiles for work entering
    ABSOLUTE rounds ``[lo, hi]``: unit k's entry round is where the
    cumulative offered-work curve reaches k, its completion round where
    the cumulative completed-work curve does. ``applied``/``gap`` are
    per-round series whose index 0 sits at absolute round
    ``first_round`` (nonzero on a resumed run).

    Offered work derives from the gap identity ``gap[r] = gap[r-1] +
    offered[r] - applied[r]`` rather than from the write count: that way
    a wipe's re-created backlog enters the offered curve at the wipe
    round (the re-applications that repay it are in the completed curve,
    so deriving offered from writes alone would understate fault-window
    latency — the one window the metric exists to grade). Negative
    deltas (a kill shrinking the live set's gap) clip to zero.

    Shared by the resilience scorecard (fault-window vs steady grading)
    and the digital twin's shadow delivery headline
    (the twin engine — the SWARM replication-latency read over
    a replayed feed). An aggregate-flow approximation, exact for FIFO
    service — stated wherever the number is published."""
    applied = np.asarray(applied, np.int64)
    gap = np.asarray(gap, np.float64)
    if applied.size == 0:
        return None
    gap_delta = np.diff(np.concatenate([[0.0], gap]))
    offered = np.maximum(
        gap_delta + applied.astype(np.float64), 0.0
    ).astype(np.int64)
    ca = np.cumsum(offered)
    cs = np.cumsum(applied)
    done = int(min(ca[-1], cs[-1]))
    if done <= 0:
        return None
    units = np.arange(1, done + 1)
    entry = np.searchsorted(ca, units) + first_round
    completion = np.searchsorted(cs, units) + first_round
    in_window = (entry >= lo) & (entry <= hi)
    if not in_window.any():
        return None
    lat = np.maximum(completion - entry, 0)[in_window]
    return {
        "p50": float(np.percentile(lat, 50)),
        "p99": float(np.percentile(lat, 99)),
        "units": int(in_window.sum()),
    }

THRESHOLDS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "resilience_thresholds.json",
)


class ResilienceScorecard:
    """Accumulating per-chunk resilience accountant for one run."""

    def __init__(self, cfg, scenario=None, workload=None,
                 round_offset: int = 0):
        self.cfg = cfg
        self.scenario = scenario
        self.workload = workload
        # what-if forks (the twin engine): node-fault schedules
        # on cfg are shifted to ABSOLUTE state rounds (fork round R +
        # relative round), while the driver's round frame — metrics,
        # converged_round, `rounds` — starts at 0. This offset maps the
        # schedule back into the driver frame wherever the two meet.
        self.round_offset = int(round_offset)
        self.heal_round = (
            scenario.heal_round if scenario is not None else None
        )
        self._fault_window = (
            scenario.fault_window() if scenario is not None else None
        )
        # per-round series for the delivery-latency read; _first_round
        # anchors series index 0 to its ABSOLUTE round (a resumed run's
        # first observed chunk starts mid-timeline, and the fault-window
        # bounds are absolute rounds)
        self._applied: list[np.ndarray] = []
        self._gap: list[np.ndarray] = []
        self._first_round: int | None = None
        self._wipes_seen = 0
        # SWIM belief churn
        self._prev_bad: np.ndarray | None = None
        self._ever_bad: np.ndarray | None = None
        self.swim_false_down = 0
        self.swim_flaps = 0
        self.rows_lost: int | None = None
        self.chunks_checked = 0

    # ------------------------------------------------------------ chunks
    def on_chunk(self, state, metrics, alive, part, start_round):
        """Fold one executed chunk in (driver-called, same cadence and
        sanction point as the invariant checker)."""
        self.chunks_checked += 1
        alive = np.asarray(alive, bool)
        if self._first_round is None:
            self._first_round = int(start_round)
        self._applied.append(
            np.asarray(metrics["fresh"], np.int64)
            + np.asarray(metrics["sync_versions"], np.int64)
        )
        self._gap.append(np.asarray(metrics["gap"], np.float64))
        if "node_fault_wipes" in metrics:
            self._wipes_seen += int(
                np.asarray(metrics["node_fault_wipes"]).sum()
            )
        if self.cfg.swim_enabled:
            from corro_sim_torch.membership.swim import down_belief_matrix

            n = alive.shape[1]
            alive_now = alive[-1]
            bad = (
                down_belief_matrix(state.swim, n)
                & alive_now[None, :] & alive_now[:, None]
            )
            if self._prev_bad is None:
                self._prev_bad = np.zeros_like(bad)
                self._ever_bad = np.zeros_like(bad)
            entered = bad & ~self._prev_bad
            self.swim_false_down += int(entered.sum())
            self.swim_flaps += int((entered & self._ever_bad).sum())
            self._ever_bad |= bad
            self._prev_bad = bad

    def on_converged(self, state, alive_now, part_now):
        """Count the cells any live node disagrees with its partition's
        reference replica on, at the moment convergence is reported —
        rows_lost == 0 is the bit-exact self-heal claim."""
        alive_now = np.asarray(alive_now, bool)
        part_now = np.asarray(part_now)
        cv = host_array(state.table.cv)
        vr = host_array(state.table.vr)
        cl = host_array(state.table.cl)
        lost = 0
        for pid in np.unique(part_now[alive_now]):
            members = np.nonzero(alive_now & (part_now == pid))[0]
            if len(members) < 2:
                continue
            ref = members[0]
            for m in members[1:]:
                lost += int(
                    (cv[ref] != cv[m]).sum() + (vr[ref] != vr[m]).sum()
                    + (cl[ref] != cl[m]).sum()
                )
        self.rows_lost = lost

    # ---------------------------------------------------------- finalize
    def _resync_rows(self, final_state, rounds: int) -> int:
        """Version-applications repaid to wiped nodes: final applied
        count minus the post-wipe baseline (amnesia restarts from zero;
        stale rejoins from the snapshot leaf's captured bookkeeping).
        Counted once per wiped NODE over its EXECUTED wipes only — a
        wipe scheduled past the run's last round never happened and must
        not credit the node's whole history as repaid, and a node wiped
        twice still repays at most its final history."""
        nf = self.cfg.node_faults
        if not nf.wipe_enabled:
            return 0
        # the LAST EXECUTED wipe per node sets its baseline: an earlier
        # wipe's repayment is overwritten by the later restart, and a
        # scheduled-but-never-executed entry must not pick the baseline
        # (kind: True = amnesia/zero, False = stale/snapshot; amnesia
        # wins a same-round collision, matching apply_node_faults)
        last: dict[int, tuple[int, bool]] = {}
        executed = (
            [(int(n), int(r), True) for n, r in nf.crash]
            + [(int(n), int(r), False) for n, _s, r in nf.stale]
        )
        for node, r, amnesia in executed:
            if r - self.round_offset >= rounds:
                continue
            prev = last.get(node)
            if prev is None or (r, amnesia) > prev:
                last[node] = (r, amnesia)
        if not last:
            return 0
        head = host_array(final_state.book.head)
        snap_head = (
            host_array(final_state.features["node_snapshot"]["head"])
            if nf.stale else None
        )
        total = 0
        for node, (_r, amnesia) in sorted(last.items()):
            base = (
                0 if amnesia or snap_head is None
                else int(snap_head[node].sum())
            )
            total += max(int(head[node].sum()) - base, 0)
        return total

    def _delivery_quantiles(self, lo: int, hi: int) -> dict | None:
        """The shared FIFO horizontal-distance read
        (:func:`fifo_delivery_quantiles`) over this run's accumulated
        series — index 0 anchored to ``_first_round`` (nonzero on a
        resumed run)."""
        if not self._applied:
            return None
        return fifo_delivery_quantiles(
            np.concatenate(self._applied), np.concatenate(self._gap),
            lo, hi, first_round=self._first_round or 0,
        )

    def _sub_delivery(self, rounds: int) -> dict | None:
        if self.workload is None or self._fault_window is None:
            return None
        lo, hi = self._fault_window
        fault = self._delivery_quantiles(lo, hi)
        steady_windows = []
        if lo > 0:
            steady_windows.append((0, lo - 1))
        if hi + 1 < rounds:
            steady_windows.append((hi + 1, rounds - 1))
        steady = None
        for w in steady_windows:
            q = self._delivery_quantiles(*w)
            if q is not None:
                steady = q if steady is None else max(
                    steady, q, key=lambda x: x["units"]
                )
        block = {
            "method": "fifo_horizontal_distance",
            "fault_window": {"rounds": [lo, hi], **(fault or {})}
            if fault else None,
            "steady": steady,
        }
        if fault and steady and steady["p99"] > 0:
            block["degradation_p99"] = round(
                fault["p99"] / steady["p99"], 3
            )
        elif fault and steady:
            block["degradation_p99"] = None
        return block

    def finalize(self, converged_round, rounds: int, final_state) -> dict:
        """The resilience block (``RunResult.resilience``)."""
        recovery = (
            converged_round - self.heal_round
            if converged_round is not None and self.heal_round is not None
            else None
        )
        resync = self._resync_rows(final_state, rounds)
        # executed wipes from the ABSOLUTE schedule, not the observed
        # metric sum — a resumed run only observes post-resume chunks,
        # but a wipe whose round already passed still happened
        wipes = sum(
            1 for _n, r in self.cfg.node_faults.wipe_schedule()
            if r - self.round_offset < rounds
        )
        block = {
            "scenario": (
                self.scenario.spec if self.scenario is not None else None
            ),
            "workload": (
                self.workload.spec if self.workload is not None else None
            ),
            "converged_round": converged_round,
            "heal_round": self.heal_round,
            "recovery_rounds": recovery,
            "rows_lost": self.rows_lost,
            "resync_rows": resync,
            "wipes": wipes,
            "wipes_observed": self._wipes_seen,
            "wipe_schedule": list(self.cfg.node_faults.wipe_schedule()),
            # belief-churn counters cover only the chunks this scorecard
            # observed (a resumed run starts at its resume round)
            "swim_false_down": self.swim_false_down,
            "swim_flaps": self.swim_flaps,
            "sub_delivery": self._sub_delivery(rounds),
            "chunks_checked": self.chunks_checked,
        }
        return block


# --------------------------------------------------- threshold gating

def load_thresholds(path: str = THRESHOLDS_PATH) -> dict | None:
    """The committed threshold golden, or None when the file is absent.
    A file that EXISTS but does not parse raises: a corrupt golden
    silently returning None would turn the threshold gate off."""
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except OSError:
        return None
    except json.JSONDecodeError as e:
        raise ValueError(
            f"resilience threshold golden {path!r} is unreadable JSON "
            f"({e}) — fix or re-baseline it; a corrupt golden must not "
            "silently disable the threshold gate"
        ) from e


def check_thresholds(block: dict, thresholds: dict) -> list[str]:
    """Grade one resilience block against the committed threshold
    golden: the ``default`` table merged under the scenario's base-name
    entry. Returns human-readable breaches (empty = pass). The golden
    is a REGRESSION tripwire, not a tight bound; the port's copy stays
    equal to the JAX package's."""
    spec = block.get("scenario") or ""
    base = spec.split(":", 1)[0]
    merged = dict(thresholds.get("default", {}))
    merged.update(thresholds.get("scenarios", {}).get(base, {}))
    breaches: list[str] = []
    if merged.get("require_converged") and block["converged_round"] is None:
        breaches.append(f"{spec}: did not re-converge")
    rec = block.get("recovery_rounds")
    if (
        merged.get("recovery_rounds_max") is not None
        and rec is not None and rec > merged["recovery_rounds_max"]
    ):
        breaches.append(
            f"{spec}: recovery_rounds {rec} > "
            f"{merged['recovery_rounds_max']}"
        )
    if (
        merged.get("rows_lost_max") is not None
        and block.get("rows_lost") is not None
        and block["rows_lost"] > merged["rows_lost_max"]
    ):
        breaches.append(
            f"{spec}: rows_lost {block['rows_lost']} > "
            f"{merged['rows_lost_max']}"
        )
    if (
        merged.get("resync_rows_min") is not None
        and block.get("resync_rows", 0) < merged["resync_rows_min"]
    ):
        breaches.append(
            f"{spec}: resync_rows {block.get('resync_rows', 0)} < "
            f"{merged['resync_rows_min']} (the stale-rejoin repayment "
            "evidence is missing)"
        )
    if (
        merged.get("swim_false_down_max") is not None
        and block.get("swim_false_down", 0)
        > merged["swim_false_down_max"]
    ):
        breaches.append(
            f"{spec}: swim_false_down {block['swim_false_down']} > "
            f"{merged['swim_false_down_max']}"
        )
    return breaches
