"""Value interning: SQLite values → dense int32 ranks, order-preserving.

Port of ``corro_sim/io/values.py`` (standard library only). The merge
compares int32 *value ranks* (:mod:`corro_sim_torch.core.crdt`), so
interning must assign ranks whose ORDER matches the conflict comparison
the real CR-SQLite extension performs on an equal-``col_version`` tie:
the SQLite type code first (descending — lower type code wins), then the
value, giving the total order

    NULL < BLOB (memcmp) < TEXT (memcmp) < REAL (numeric) < INTEGER

with INTEGER and REAL in *separate bands* (int 3 beats float 3.0).
SQL-visible comparisons follow SQLite's own order — NULL < numerics
(int/real interleaved numerically) < TEXT < BLOB — via
:func:`sqlite_sort_key` host-side, and via the band-aware multi-range
compilation of :class:`_BandRanges` (used by
:mod:`corro_sim_torch.subs.query`) for rank-space predicates. Trace
replay interns a closed world (:class:`ValueInterner`); a live writer
interns online, with gaps (:class:`LiveUniverse`). The wire shape being
interned is the reference's ``SqliteValue`` tagged union
(``corro-api-types/src/lib.rs:455-715``).
"""

from __future__ import annotations

# conflict-order bands (see module docstring)
B_NULL, B_BLOB, B_TEXT, B_FLOAT, B_INT = 0, 1, 2, 3, 4


def sqlite_sort_key(value):
    """Total-order sort key matching SQLite's cross-type value comparison
    (the SQL-visible order: WHERE/ORDER BY/min()/max() semantics)."""
    if value is None:
        return (0,)
    if isinstance(value, bool):  # JSON true/false arrive as ints in SQLite
        return (1, float(int(value)))
    if isinstance(value, (int, float)):
        return (1, float(value))
    if isinstance(value, str):
        return (2, value.encode("utf-8"))
    if isinstance(value, (bytes, bytearray)):
        return (3, bytes(value))
    raise TypeError(f"not a SQLite value: {type(value)!r}")


def crsql_conflict_key(value):
    """Total-order sort key matching the EXTENSION's equal-col_version
    conflict comparison (type-code descending, then natural within-type;
    measured in tests/test_crsqlite_oracle.py). Also the universal dict
    key for interning: it distinguishes int 3 from float 3.0, which the
    conflict order treats as different values."""
    if value is None:
        return (B_NULL,)
    if isinstance(value, bool):
        return (B_INT, int(value))
    if isinstance(value, int):
        return (B_INT, value)
    if isinstance(value, float):
        return (B_FLOAT, value)
    if isinstance(value, str):
        return (B_TEXT, value.encode("utf-8"))
    if isinstance(value, (bytes, bytearray)):
        return (B_BLOB, bytes(value))
    raise TypeError(f"not a SQLite value: {type(value)!r}")


class _BandRanges:
    """SQL-semantics comparisons compiled over a conflict-ordered rank
    space. Mixin for universes that provide ``_edge(key, right)`` — the
    rank edge at a conflict-key insertion point (bisect_left/right).

    SQL's cross-type comparison order is NULL < numerics (int and real
    interleaved NUMERICALLY) < TEXT < BLOB, but the rank space is laid
    out in conflict order (blob < text < float < int), so one SQL
    comparison becomes up to three disjoint rank ranges.
    """

    def _band(self, b):
        """[lo, hi) rank extent of band ``b``."""
        return self._edge((b,), False), self._edge((b + 1,), False)

    def _pin(self, key) -> None:
        """Hook: online universes intern the literal behind a compiled
        edge so the edge is an exact member rank — later insertions land
        strictly on the correct side of it. No-op for closed worlds."""

    @staticmethod
    def _clamp(lo, hi, band_lo, band_hi):
        return max(lo, band_lo), min(hi, band_hi)

    def eq_ranges(self, lit):
        """Rank ranges of stored values SQL-== lit (int 3 == real 3.0)."""
        if lit is None:
            return ((self._edge((B_NULL,), False),
                     self._edge((B_NULL + 1,), False)),)
        out = []
        if isinstance(lit, bool):
            cands = [(B_INT, int(lit)), (B_FLOAT, float(lit))]
        elif isinstance(lit, int):
            cands = [(B_INT, lit)]
            if float(lit) == lit:  # exact double — else no float can == lit
                cands.append((B_FLOAT, float(lit)))
        elif isinstance(lit, float):
            if lit != lit:  # SQL: NaN equals nothing
                return ()
            cands = [(B_FLOAT, lit)]
            if lit.is_integer():  # finite integral double: exact int twin
                cands.append((B_INT, int(lit)))
        else:
            cands = [crsql_conflict_key(lit)]
        for k in cands:
            self._pin(k)
            lo = self._edge(k, False)
            hi = self._edge(k, True)
            if hi > lo:
                out.append((lo, hi))
        return tuple(out)

    def sql_ranges(self, lit, op):
        """Rank ranges satisfying ``stored <op> lit`` under SQL comparison
        semantics (NULL never matches; the caller masks NULLs)."""
        assert op in ("<", "<=", ">", ">="), op
        lt = op in ("<", "<=")
        incl = op in ("<=", ">=")
        out = []

        def below(band, key=None):
            blo, bhi = self._band(band)
            lo, hi = blo, bhi
            if key is not None:
                self._pin(key)
                lo, hi = self._clamp(blo, self._edge(key, incl), blo, bhi)
            if hi > lo:
                out.append((lo, hi))

        def above(band, key=None):
            blo, bhi = self._band(band)
            lo, hi = blo, bhi
            if key is not None:
                self._pin(key)
                lo, hi = self._clamp(self._edge(key, not incl), bhi, blo, bhi)
            if hi > lo:
                out.append((lo, hi))

        if isinstance(lit, (int, float)):
            import math

            n = int(lit) if isinstance(lit, bool) else lit
            if isinstance(n, float) and n != n:
                return ()  # SQL: NaN compares with nothing
            # int-band cut: an exact INTEGER key with adjusted inclusivity
            # (the band stores ints; a fractional literal falls between)
            if isinstance(n, float) and not (
                math.isinf(n) or n.is_integer()
            ):
                ik = (B_INT, math.floor(n))
                i_incl_lt, i_incl_gt = True, False  # < 1.5 == <= 1; > 1.5 == >= 2 == > 1
            elif isinstance(n, float) and math.isinf(n):
                ik = None  # handled via whole-band inclusion below
                i_incl_lt = i_incl_gt = False
            else:
                ik = (B_INT, int(n))
                i_incl_lt = i_incl_gt = incl
            # float-band cut: the nearest double, inclusivity adjusted
            # when the literal is not exactly representable (|int| > 2^53)
            fl = float(n)
            if fl == n:
                f_incl_lt = f_incl_gt = incl
            else:
                f_incl_lt = fl < n  # include fl in '< n' iff fl < n
                f_incl_gt = fl > n

            def cut(band, key, use_incl):
                # like below/above but with per-band inclusivity
                nonlocal out
                blo, bhi = self._band(band)
                if lt:
                    self._pin(key)
                    lo, hi = self._clamp(
                        blo, self._edge(key, use_incl), blo, bhi
                    )
                else:
                    self._pin(key)
                    lo, hi = self._clamp(
                        self._edge(key, not use_incl), bhi, blo, bhi
                    )
                if hi > lo:
                    out.append((lo, hi))

            if lt:
                if isinstance(n, float) and math.isinf(n):
                    if n > 0:  # < +inf: all numbers except +inf itself
                        below(B_FLOAT, (B_FLOAT, n))
                        below(B_INT)
                        if incl:  # <= +inf also matches a stored +Inf
                            out.extend(self.eq_ranges(n))
                    elif incl:  # <= -inf matches exactly a stored -Inf
                        out.extend(self.eq_ranges(n))
                else:
                    cut(B_FLOAT, (B_FLOAT, fl), f_incl_lt)
                    if ik is not None:
                        cut(B_INT, ik, i_incl_lt)
            else:
                if isinstance(n, float) and math.isinf(n):
                    if n < 0:  # > -inf: all numbers except -inf itself
                        above(B_FLOAT, (B_FLOAT, n))
                        below(B_INT)
                        if incl:  # >= -inf also matches a stored -Inf
                            out.extend(self.eq_ranges(n))
                    elif incl:  # >= +inf matches exactly a stored +Inf
                        out.extend(self.eq_ranges(n))
                else:
                    cut(B_FLOAT, (B_FLOAT, fl), f_incl_gt)
                    if ik is not None:
                        cut(B_INT, ik, i_incl_gt)
                below(B_TEXT)  # SQL: every text/blob > any number
                below(B_BLOB)
        elif isinstance(lit, str):
            k = (B_TEXT, lit.encode("utf-8"))
            if lt:
                below(B_FLOAT)  # SQL: every number < any text
                below(B_INT)
                below(B_TEXT, k)
            else:
                above(B_TEXT, k)
                below(B_BLOB)  # SQL: every blob > any text
        elif isinstance(lit, (bytes, bytearray)):
            k = (B_BLOB, bytes(lit))
            if lt:
                below(B_FLOAT)
                below(B_INT)
                below(B_TEXT)
                below(B_BLOB, k)
            else:
                above(B_BLOB, k)
        else:
            raise TypeError(f"not a SQLite value: {type(lit)!r}")
        return tuple(out)


class ValueInterner:
    """Assigns conflict-order-preserving dense ranks to a closed set of
    values (rank order == the extension's equal-cv conflict order, so the
    merge kernel's integer max IS the CR-SQLite tie-break).

    Two-phase by design: collect every value appearing in a trace, then
    ``freeze()`` to get ranks. (An online order-preserving assignment can't
    be dense; traces are replayed from files, so the closed-world phase is
    free.)
    """

    def __init__(self):
        self._values: dict = {}  # conflict key -> value
        self._ranks: dict | None = None

    def add(self, value) -> None:
        if self._ranks is not None:
            raise RuntimeError("interner is frozen")
        v = _hashable(value)
        self._values[crsql_conflict_key(v)] = v

    def freeze(self) -> None:
        self._ranks = {k: i for i, k in enumerate(sorted(self._values))}

    def rank(self, value) -> int:
        if self._ranks is None:
            raise RuntimeError("freeze() the interner before ranking")
        return self._ranks[crsql_conflict_key(_hashable(value))]

    def __len__(self) -> int:
        return len(self._values)


def _hashable(value):
    if isinstance(value, bytearray):
        return bytes(value)
    return value


class LiveUniverse(_BandRanges):
    """Conflict-order-preserving *online* interning for live writes.

    Trace replay interns a closed world (:class:`ValueInterner`). A live
    agent accepting ``/v1/transactions`` sees new values forever, so ranks
    are assigned with gaps: a new value between two band neighbors takes
    the midpoint rank. Each conflict band owns a STATIC rank region
    (``[band * SPAN, (band+1) * SPAN)``) — compiled predicates capture
    band edges as constants, and those must never move no matter what is
    interned later. When a band's gap is exhausted that band is re-spaced
    and every listener is told to remap its rank-typed tensors (old→new is
    order-preserving, so CRDT merge outcomes are unchanged — the tie-break
    only reads rank *order*, matching the extension's conflict compare).

    Satisfies the matcher-facing universe protocol (``rank_of`` /
    ``eq_ranges`` / ``sql_ranges`` / ``decode``) used by
    :mod:`corro_sim_torch.subs.query`.
    """

    SPAN = 1 << 28  # static rank region per band (5 bands < 2^31)
    GAP = 1 << 14

    def __init__(self, initial=()):
        uniq = {crsql_conflict_key(_hashable(v)): _hashable(v)
                for v in initial}
        keys = sorted(uniq)
        self._values: list = [uniq[k] for k in keys]
        self._keys = keys
        self._ranks: list[int] = self._band_spread(keys)
        self._by_value: dict = dict(zip(keys, self._ranks))
        self.version = 0  # bumped on every remap
        self._remap_listeners: list = []
        self.pending_remap: tuple | None = None  # set by restore() when
        # the stored ranks violate the banded conflict order (pre-r4
        # checkpoints)

    @classmethod
    def _band_spread(cls, sorted_keys) -> list[int]:
        """Dense band-homed ranks for conflict-sorted keys: each band's
        members spread evenly inside its STATIC region (GAP spacing while
        it fits, tighter as the band fills; a band can hold SPAN/2
        values before ranks run out)."""
        totals: dict[int, int] = {}
        for k in sorted_keys:
            totals[k[0]] = totals.get(k[0], 0) + 1
        step = {}
        for b, n in totals.items():
            if n >= cls.SPAN // 2:
                raise ValueError(
                    f"value band {b} holds {n} values — exceeds the "
                    f"rank region capacity {cls.SPAN // 2}"
                )
            step[b] = max(min(cls.GAP, cls.SPAN // (n + 1)), 1)
        out = []
        counts: dict[int, int] = {}
        for k in sorted_keys:
            b = k[0]
            i = counts.get(b, 0)
            counts[b] = i + 1
            out.append(b * cls.SPAN + (i + 1) * step[b])
        return out

    def __len__(self) -> int:
        return len(self._values)

    @classmethod
    def restore(cls, values, ranks) -> "LiveUniverse":
        """Rebuild a universe with its exact value→rank assignment (warm
        checkpoint restore: stored tensors hold these ranks).

        A checkpoint written under the pre-r4 SQL-ordered (or un-banded)
        rank space is re-ranked into the banded conflict order;
        ``pending_remap`` then carries the (old_ranks, new_ranks)
        translation the caller must apply to every rank-typed tensor
        before installing it."""
        u = cls()
        vals = [_hashable(v) for v in values]
        keys = [crsql_conflict_key(v) for v in vals]
        old = [int(r) for r in ranks]
        order = sorted(range(len(vals)), key=lambda i: keys[i])
        compatible = (
            all(keys[order[j]] == keys[j] for j in range(len(vals)))
            and all(old[j] < old[j + 1] for j in range(len(vals) - 1))
            and all(
                keys[j][0] * cls.SPAN <= old[j] < (keys[j][0] + 1) * cls.SPAN
                for j in range(len(vals))
            )
        )
        if compatible:
            u._values = list(vals)
            u._keys = keys
            u._ranks = old
            u._by_value = dict(zip(keys, old))
            return u
        u._values = [vals[i] for i in order]
        u._keys = [keys[i] for i in order]
        u._ranks = u._band_spread(u._keys)
        u._by_value = dict(zip(u._keys, u._ranks))
        # translate_ranks needs the old-rank table ascending; checkpoint
        # order is conflict-key order, whose old ranks may not be
        pairs = sorted(
            (old[i], u._by_value[keys[i]]) for i in range(len(vals))
        )
        u.pending_remap = (
            [p[0] for p in pairs], [p[1] for p in pairs],
        )
        return u

    def snapshot(self) -> tuple[list, list[int]]:
        """(values, ranks) parallel lists — feed to :meth:`restore`."""
        return list(self._values), list(self._ranks)

    def on_remap(self, fn) -> None:
        """``fn(old_ranks: list[int], new_ranks: list[int])`` — called with
        parallel arrays whenever the space is re-spaced."""
        self._remap_listeners.append(fn)

    def _neighbors(self, i: int, band: int) -> tuple[int, int]:
        """(lo, hi) open rank interval for an insertion at index ``i`` of
        a band-``band`` value: band-local neighbors, clamped to the band's
        static region so a new value can never cross a compiled edge."""
        lo = band * self.SPAN
        hi = (band + 1) * self.SPAN
        if i > 0 and self._keys[i - 1][0] == band:
            lo = self._ranks[i - 1]
        if i < len(self._keys) and self._keys[i][0] == band:
            hi = self._ranks[i]
        return lo, hi

    def rank(self, value) -> int:
        """Intern ``value`` (idempotent) and return its rank."""
        import bisect

        v = _hashable(value)
        k = crsql_conflict_key(v)
        r = self._by_value.get(k)
        if r is not None:
            return r
        band = k[0]
        i = bisect.bisect_left(self._keys, k)
        lo, hi = self._neighbors(i, band)
        if hi - lo < 2:
            self._respace()
            i = bisect.bisect_left(self._keys, k)
            lo, hi = self._neighbors(i, band)
        r = (lo + hi) // 2
        self._values.insert(i, v)
        self._keys.insert(i, k)
        self._ranks.insert(i, r)
        self._by_value[k] = r
        return r

    def intern_many(self, values) -> None:
        """Bulk-intern with at most ONE re-space for the whole batch.

        ``rank()`` re-spaces whenever a midpoint gap is exhausted; a batch
        of fresh values (a /v1/transactions body) inserted one at a time
        can exhaust dozens of gaps → dozens of remap notifications, each of
        which rewrites every rank-typed device tensor. Here: group the new
        values by insertion gap, midpoint-insert when every group fits, and
        otherwise merge + re-space ONCE (one listener fire)."""
        import bisect
        from collections import defaultdict

        fresh = {crsql_conflict_key(_hashable(v)): _hashable(v)
                 for v in values}
        new = [fresh[k] for k in sorted(fresh.keys() - self._by_value.keys())]
        if not new:
            return
        groups: dict[int, list] = defaultdict(list)
        for v in new:
            groups[
                bisect.bisect_left(self._keys, crsql_conflict_key(v))
            ].append(v)
        fits = all(
            (lambda lo_hi: lo_hi[1] - lo_hi[0] - 1)(
                self._neighbors(i, crsql_conflict_key(g[0])[0])
            ) >= len(g)
            for i, g in groups.items()
        )
        # a group spanning two bands at one insertion index must fit each
        # band's side independently; re-space handles the rare mixed case
        fits = fits and all(
            len({crsql_conflict_key(v)[0] for v in g}) == 1
            for g in groups.values()
        )
        if fits:
            # evenly spread each group inside its band-local gap; insert
            # descending by index so earlier indices stay valid
            for i in sorted(groups, reverse=True):
                g = groups[i]
                band = crsql_conflict_key(g[0])[0]
                lo, hi = self._neighbors(i, band)
                step = max((hi - lo) // (len(g) + 1), 1)
                for j, v in enumerate(g):
                    r = lo + step * (j + 1)
                    k = crsql_conflict_key(v)
                    self._values.insert(i + j, v)
                    self._keys.insert(i + j, k)
                    self._ranks.insert(i + j, r)
                    self._by_value[k] = r
            return
        # merge + single re-space
        old_keys = list(self._keys)
        old_ranks = list(self._ranks)
        pairs = dict(zip(self._keys, self._values))
        pairs.update((crsql_conflict_key(v), v) for v in new)
        merged = sorted(pairs)
        self._keys = merged
        self._values = [pairs[k] for k in merged]
        self._ranks = self._band_spread(merged)
        self._by_value = dict(zip(self._keys, self._ranks))
        self.version += 1
        new_ranks = [self._by_value[k] for k in old_keys]
        for fn in self._remap_listeners:
            fn(old_ranks, new_ranks)

    def _respace(self) -> None:
        import time as _time

        from corro_sim_torch.utils.metrics import histograms as _histograms

        _t0 = _time.perf_counter()
        try:
            return self._respace_inner()
        finally:
            _histograms.observe(
                "corro_db_incremental_vacuum_seconds",
                _time.perf_counter() - _t0,
                help_="rank-space respace wall (universe remap; "
                      "corro.db.incremental.vacuum.seconds analog)",
            )

    def _respace_inner(self) -> None:
        old = list(self._ranks)
        self._ranks = self._band_spread(self._keys)
        self._by_value = dict(zip(self._keys, self._ranks))
        self.version += 1
        for fn in self._remap_listeners:
            fn(old, list(self._ranks))

    # ---- matcher universe protocol -------------------------------------
    def _edge(self, key, right: bool) -> int:
        """Rank edge at a conflict-key cut point. Band-sentinel keys
        ``(b,)`` map to the STATIC region boundary ``b * SPAN`` —
        constants a compiled predicate can safely capture. Value keys map
        to the first in-band member at/after the cut, or the band's
        static end when none exists (later insertions stay inside the
        band region, so the captured edge stays correct)."""
        import bisect

        if len(key) == 1:
            return key[0] * self.SPAN
        band = key[0]
        r = self._by_value.get(key)
        if r is not None:
            # the cut value is a member (compiled edges always are — _pin):
            # the exclusive side is ITS rank + 1, not the next member's
            # rank — values interned later between the two must stay on
            # the greater side of the captured edge.
            return r + 1 if right else r
        i = (bisect.bisect_right if right else bisect.bisect_left)(
            self._keys, key
        )
        if i < len(self._keys) and self._keys[i][0] == band:
            return self._ranks[i]
        return (band + 1) * self.SPAN

    def _pin(self, key) -> None:
        """Intern the value behind a compiled edge (see _BandRanges._pin):
        with the literal itself a member, the captured edge is its exact
        rank and every later insertion sorts strictly to one side."""
        band = key[0]
        if band == B_INT:
            self.rank(int(key[1]))
        elif band == B_FLOAT:
            self.rank(float(key[1]))
        elif band == B_TEXT:
            self.rank(key[1].decode("utf-8"))
        elif band == B_BLOB:
            self.rank(key[1])

    def rank_of(self, lit):
        """(lo, hi): stored ranks r with conflict-key == lit's satisfy
        lo <= r < hi (exact band+value identity — SQL-semantics equality
        across int/real is :meth:`eq_ranges`).

        For an un-interned literal both bounds collapse to the insertion
        point, so ``=`` matches nothing while same-band order edges (the
        LIKE prefix cuts) stay correct."""
        k = crsql_conflict_key(_hashable(lit))
        r = self._by_value.get(k)
        if r is not None:
            return r, r + 1
        edge = self._edge(k, False)
        return edge, edge

    def decode(self, rank: int):
        import bisect

        i = bisect.bisect_left(self._ranks, rank)
        if i < len(self._ranks) and self._ranks[i] == rank:
            return self._values[i]
        raise KeyError(f"rank {rank} not in universe")
