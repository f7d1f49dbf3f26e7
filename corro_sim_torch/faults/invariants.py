"""Invariant checkers: the assertions that must hold under ANY fault mix.

Port of ``corro_sim/faults/invariants.py`` (host numpy). The checker
reads a state's leaves through ``utils/runtime.py::host_array``, so it
takes the port's state on either device, or a host copy of the leaves
it reads (``engine/driver.py`` hands it the chunk-boundary copy it
fetched before the next chunk was queued). The SWIM check's streak
clock is kept per node and per split pair instead of as one (N, N)
plane updated every round, with the same values.

Chaos injection is only evidence if something checks the wreckage. These
checkers run host-side between driver chunks (opt-in — one extra
device→host read of the bookkeeping planes per chunk) and accumulate
:class:`InvariantViolation` records instead of raising, so a soak run
reports every broken property, not just the first:

- **head monotonicity** — a node's applied version head per actor never
  decreases: loss, duplication, churn and partitions may stall progress
  but can never un-apply a version (the reference's bookkeeping is
  insert-or-max, never decrement);
- **bookkeeping conservation** — every emitted message is accounted for,
  round by round: ``sent + matured == parked + emit_lost + delivered +
  unreachable + blackholed + lost`` (the fault metrics from
  ``engine/step.py``; checkable only while faults are enabled, which is
  when it matters);
- **convergence honesty** — when the driver reports convergence, every
  pair of live same-partition nodes must actually agree on table state
  (checked pairwise against a per-partition reference replica);
- **SWIM liveness honesty** — a node that has been up and reachable by
  an observer for longer than the suspicion window (plus refutation
  slack) must not be marked DOWN in that observer's belief: the failure
  detector may be slow, never permanently wrong about a live peer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from corro_sim_torch.utils.runtime import host_array

__all__ = ["InvariantChecker", "InvariantViolation", "merge_reports"]



def merge_reports(reports: list) -> dict:
    """Fold many per-run checker reports (``InvariantChecker.report()``
    dicts) into one summary — the sweep engine grades every lane with
    its own checker, and the matrix report needs the one-line verdict:
    overall ok, total chunks checked, and the violations with their
    originating lane index attached."""
    violations = []
    chunks = 0
    for i, rep in enumerate(reports):
        if rep is None:
            continue
        chunks += int(rep.get("chunks_checked", 0))
        for v in rep.get("violations", []):
            violations.append({"lane": i, **v})
    return {
        "ok": not violations,
        "lanes_checked": sum(1 for r in reports if r is not None),
        "chunks_checked": chunks,
        "violations": violations,
    }


@dataclasses.dataclass
class InvariantViolation:
    round: int | None  # absolute 0-based round (None: end-of-run check)
    invariant: str
    detail: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class InvariantChecker:
    """Accumulating per-chunk invariant checker for ``run_sim``.

    Pass one via ``run_sim(..., invariants=InvariantChecker(cfg))``;
    read ``.violations`` / ``.report()`` afterwards. Stateless apart
    from the previous chunk's snapshots, so one instance covers one run.
    """

    def __init__(self, cfg, round_offset: int = 0):
        self.cfg = cfg
        self.violations: list[InvariantViolation] = []
        self.chunks_checked = 0
        self._prev_head: np.ndarray | None = None
        # the SWIM check's clock: rounds each directed pair has been
        # continuously mutually-reachable with both ends up, kept as the
        # last round each node was down (N,) and the last round each
        # pair sat in different partitions (N, N; None until parts
        # first differ), over ``_rounds`` rounds seen
        self._last_down: np.ndarray | None = None
        self._last_split: np.ndarray | None = None
        self._rounds = 0
        # scheduled node wipes (faults/nodes.py): the ONE sanctioned way
        # an applied head may decrease — a crash-restart losing its DB is
        # the fault being injected, not a bookkeeping bug. Only the
        # scheduled (node, round) entries are exempt, and only for the
        # chunk the wipe lands in; any other decrease still violates.
        # ``round_offset``: what-if forks (the twin engine) schedule
        # faults at ABSOLUTE state rounds (fork round + k) while the
        # driver frame starts at 0 — map the exemptions back.
        self._wipe_schedule = tuple(
            (n, r - int(round_offset))
            for n, r in cfg.node_faults.wipe_schedule()
        )

    # ------------------------------------------------------------- checks
    def on_chunk(self, state, metrics, alive, part, start_round):
        """Run every per-chunk invariant; returns the NEW violations.

        ``alive``/``part``: the chunk's ground-truth schedule rows
        ((chunk, n)); ``start_round``: absolute 0-based round of the
        chunk's first row."""
        new: list[InvariantViolation] = []
        alive = np.asarray(alive, bool)
        part = np.asarray(part)
        chunk = alive.shape[0]
        self.chunks_checked += 1

        # ---- applied-head monotonicity per (node, actor)
        head = host_array(state.book.head)
        if self._prev_head is not None:
            dec = head < self._prev_head
            for node, r in self._wipe_schedule:
                if start_round <= r < start_round + chunk:
                    dec[node, :] = False  # scheduled crash-restart wipe
            if dec.any():
                i, a = np.argwhere(dec)[0]
                new.append(InvariantViolation(
                    start_round + chunk - 1, "head_monotonicity",
                    f"book.head[{i}, {a}] decreased "
                    f"{int(self._prev_head[i, a])} → {int(head[i, a])} "
                    f"(+{int(dec.sum()) - 1} more entries)",
                ))
        self._prev_head = head

        # ---- bookkeeping conservation (fault metrics present ⇔ faults on)
        if "fault_delivered" in metrics:
            sent = np.asarray(metrics["msgs_sent"], np.int64)
            lhs = sent + np.asarray(metrics["fault_matured"], np.int64)
            rhs = (
                np.asarray(metrics["fault_parked"], np.int64)
                + np.asarray(metrics["fault_emit_lost"], np.int64)
                + np.asarray(metrics["fault_delivered"], np.int64)
                + np.asarray(metrics["fault_unreachable"], np.int64)
                + np.asarray(metrics["fault_blackholed"], np.int64)
                + np.asarray(metrics["fault_lost"], np.int64)
            )
            bad = lhs != rhs
            if bad.any():
                t = int(np.argmax(bad))
                new.append(InvariantViolation(
                    start_round + t, "conservation",
                    f"sent+matured={int(lhs[t])} != parked+emit_lost+"
                    f"delivered+unreachable+blackholed+lost={int(rhs[t])}"
                    f" ({int(bad.sum())} bad rounds in chunk)",
                ))

        # ---- SWIM: no live long-reachable node marked DOWN
        self._update_reach_streak(alive, part)
        if self.cfg.swim_enabled:
            v = self._check_swim(state, alive[-1], start_round + chunk - 1)
            if v is not None:
                new.append(v)

        self.violations.extend(new)
        return new

    def _update_reach_streak(self, alive, part):
        """Advance the streak clock over the chunk's rounds. A pair is
        unreachable in a round where either end is down or their
        partitions differ, so its streak is the rounds since the latest
        of: either end's last down round, the pair's last split round.
        The per-node term costs O(N) a round; the (N, N) split term is
        updated only in rounds whose partitions differ, once per run of
        equal rows. Equal to the JAX package's round-by-round (N, N)
        update (``_reach_streak``)."""
        rounds, n = alive.shape
        if self._last_down is None:
            self._last_down = np.full((n,), -1, np.int64)
        t0 = self._rounds
        for t in range(rounds):
            self._last_down[~alive[t]] = t0 + t
        t = 0
        while t < rounds:
            k = 1
            while t + k < rounds and np.array_equal(part[t + k], part[t]):
                k += 1
            if (part[t] != part[t][0]).any():
                if self._last_split is None:
                    self._last_split = np.full((n, n), -1, np.int64)
                self._last_split[part[t][:, None] != part[t][None, :]] = (
                    t0 + t + k - 1)
            t += k
        self._rounds = t0 + rounds

    @property
    def _reach_streak(self) -> np.ndarray | None:
        """(N, N) rounds each directed pair has been continuously
        mutually reachable with both ends up (None before any chunk)."""
        if self._last_down is None:
            return None
        last = np.maximum.outer(self._last_down, self._last_down)
        if self._last_split is not None:
            last = np.maximum(last, self._last_split)
        return (self._rounds - 1) - last

    def _swim_window_rounds(self) -> int:
        """Rounds a (kill → refutation-gossip) cycle may legitimately
        take: suspicion timeout + announce cadence + dissemination slack,
        all stretched by the SWIM tick interval."""
        cfg = self.cfg
        return int(cfg.swim_interval) * (
            int(cfg.swim_suspect_rounds)
            + int(cfg.swim_announce_interval) + 8
        )

    def _check_swim(self, state, alive_now, round_idx):
        window = self._swim_window_rounds()
        streak = self._reach_streak
        ok_pairs = streak > window  # (observer, subject)
        if not ok_pairs.any():
            return None
        from corro_sim_torch.membership.swim import down_belief_matrix

        n = alive_now.shape[0]
        # [observer, subject] — the canonical belief decoding, shared so
        # a layout change cannot silently desync this checker
        down_belief = down_belief_matrix(state.swim, n)
        bad = down_belief & ok_pairs & alive_now[:, None]
        if bad.any():
            i, j = np.argwhere(bad)[0]
            return InvariantViolation(
                round_idx, "swim_false_down",
                f"observer {i} believes live node {j} DOWN after "
                f"{int(streak[i, j])} rounds of mutual "
                f"reachability (window {window})",
            )
        return None

    def on_converged(self, state, alive_now, part_now):
        """The convergence-honesty check: called by the driver at the
        moment it reports convergence. Every live node must agree with
        its partition's reference replica on the full table state."""
        new: list[InvariantViolation] = []
        alive_now = np.asarray(alive_now, bool)
        part_now = np.asarray(part_now)
        cv = host_array(state.table.cv)
        vr = host_array(state.table.vr)
        cl = host_array(state.table.cl)
        for pid in np.unique(part_now[alive_now]):
            members = np.nonzero(alive_now & (part_now == pid))[0]
            if len(members) < 2:
                continue
            ref = members[0]
            for m in members[1:]:
                if not (
                    np.array_equal(cv[ref], cv[m])
                    and np.array_equal(vr[ref], vr[m])
                    and np.array_equal(cl[ref], cl[m])
                ):
                    ncell = int(
                        (cv[ref] != cv[m]).sum() + (vr[ref] != vr[m]).sum()
                    )
                    new.append(InvariantViolation(
                        None, "convergence_disagreement",
                        f"converged reported but live nodes {int(ref)} and "
                        f"{int(m)} (partition {int(pid)}) differ on "
                        f"~{ncell} cells",
                    ))
                    break  # one witness per partition is enough
        self.violations.extend(new)
        return new

    # ------------------------------------------------------------ reporting
    @property
    def ok(self) -> bool:
        return not self.violations

    def report(self) -> dict:
        return {
            "ok": self.ok,
            "chunks_checked": self.chunks_checked,
            "violations": [v.as_dict() for v in self.violations],
        }
