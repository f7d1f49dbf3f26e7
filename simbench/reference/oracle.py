"""The plain reference of a cluster's answer, and the judge of a run.

The configurations state one guarantee: eventual consistency under
last-writer-wins. Every write a live node makes is kept, in its
writer's change log as the writer drew it, and at convergence every
live node holds every write, so that each cell holds the write whose
``(col_version, value, site)`` triple is largest (CR-SQLite's LWW rule)
and each row that was ever written has causal length 1 (no deletes).

The judge works out the writes again from the seed (``draws.py``) and
holds a run's outputs to them. It reads, of the program, only the
outputs it judges: each node's cell planes and version heads, and the
writers' change logs. A write's col_version is one more than the
col_version its writer held for the cell when it wrote; which writes it
had received by then only a second simulator could follow. Where the
draws alone fix it (every earlier write to the cell is the writer's
own, or there is none: :func:`cv_pinned`) the judge requires it
exactly; elsewhere it takes it from the writer's log and bounds it (at
least one more than the writer's own earlier write to that cell, at
most one more than the writes to that cell in earlier rounds). The
stage this skips, the stamp itself, is checked by :func:`stamps_wrong`
against the writer's plane round by round.

Every number the judge returns counts faults; a sound run reads 0 in
each.
"""

from __future__ import annotations

import numpy as np

NEG = -(2 ** 31)
VAL_BITS = 20  # values and sites each fit 20 bits: the key packs them
SITE_BITS = 20
CV_LIMIT = 1 << 22

# the order of the change log's packed cell words
CELL_ROW, CELL_COL, CELL_VR, CELL_CV, CELL_CL = range(5)

CHECKS = ("writes_wrong", "cv_wrong", "heads_wrong", "cells_wrong",
          "rounds_wrong")


def lww_key(cv, vr, site):
    """One int64 per triple, ordered as the triples are."""
    return ((np.asarray(cv, np.int64) << (VAL_BITS + SITE_BITS))
            | (np.asarray(vr, np.int64) << SITE_BITS)
            | np.asarray(site, np.int64))


def versions(node: np.ndarray, num_nodes: int) -> tuple:
    """``(version, count)``: each write's 1-based version within its
    writer, given writes sorted by round; and the writes per node."""
    count = np.bincount(node, minlength=num_nodes).astype(np.int64)
    order = np.argsort(node, kind="stable")
    starts = np.concatenate([[0], np.cumsum(count)[:-1]])
    ver = np.empty(node.size, np.int64)
    ver[order] = np.arange(node.size) - np.repeat(starts, count) + 1
    return ver, count


def _earlier(key: np.ndarray, rnd: np.ndarray, span: int) -> np.ndarray:
    """For each write, how many writes with the same ``key`` came in
    earlier rounds."""
    ck = np.sort(key * span + rnd)
    return (np.searchsorted(ck, key * span + rnd, "left")
            - np.searchsorted(ck, key * span, "left"))


def cv_pinned(writes: dict, *, num_nodes: int, num_cols: int) -> tuple:
    """``(pinned, prior)``: whether each write's col_version is fixed by
    the draws alone, and the writes to its cell in earlier rounds.

    A writer holds its own writes; a write made in the same round by
    another node reaches it only after it wrote (the step writes before
    it delivers). So where every write to the cell in earlier rounds is
    the writer's own, or there is none, the writer held exactly those,
    each stamped one more than the one before, and its write is stamped
    ``1 + prior``."""
    node = writes["node"].astype(np.int64)
    cell = writes["row"].astype(np.int64) * num_cols + writes["col"]
    rnd = writes["round"].astype(np.int64)
    span = int(rnd.max()) + 1 if rnd.size else 1
    prior = _earlier(cell, rnd, span)
    own = _earlier(cell * num_nodes + node, rnd, span)
    return prior == own, prior


def stamps_wrong(writes: dict, logged_cv: np.ndarray,
                 planes: list) -> int:
    """Writes whose col_version is not one more than the col_version its
    writer held for the cell at the start of its round.

    ``logged_cv``: each write's col_version as its writer logged it;
    ``planes``: for each write round ``r``, the program's cv plane
    ``(N, rows, cols)`` after ``r`` rounds (the state the round starts
    from). This follows the program from its own state, round by round:
    the stage the judge of a whole run only bounds."""
    rnd = writes["round"].astype(np.int64)
    held = np.zeros(rnd.size, np.int64)
    for r in np.unique(rnd):
        at = rnd == r
        held[at] = planes[int(r)][writes["node"][at], writes["row"][at],
                                  writes["col"][at]]
    return int((np.asarray(logged_cv, np.int64) != held + 1).sum())


def judge(writes: dict, out: dict, *, num_nodes: int, num_rows: int,
          num_cols: int, alive_end: np.ndarray, converge: bool) -> dict:
    """Hold one cluster's outputs to its writes.

    ``writes``: :func:`draws.draw_writes`'s record. ``out``: the run's
    outputs as numpy: ``cv``, ``vr``, ``site`` ``(N, rows, cols)``,
    ``cl`` ``(N, rows)``, ``head`` ``(N, N)`` (node by actor),
    ``log_head`` ``(N,)``, ``log_cells`` ``(N, H, S, 5)`` and
    ``log_ncells`` ``(N, H)`` for the first ``H`` versions of each actor.
    ``alive_end``: the nodes up at the last round. ``converge``: the run
    claims convergence, so every live node must hold every write.

    Returns the fault counts ``writes_wrong``, ``cv_wrong``,
    ``heads_wrong`` and ``cells_wrong``."""
    n, cols = num_nodes, num_cols
    cells = num_rows * num_cols
    node = writes["node"].astype(np.int64)
    ver, count = versions(node, n)
    cell = writes["row"].astype(np.int64) * cols + writes["col"]

    # -- the change log: every write recorded by its writer, as drawn
    log_head = out["log_head"].astype(np.int64)
    writes_wrong = int(np.abs(log_head - count).sum())
    h = out["log_cells"].shape[1]
    logged = ver <= np.minimum(log_head[node], h)
    rec = np.zeros((node.size, 5), np.int64)
    ncl = np.zeros(node.size, np.int64)
    rec[logged] = out["log_cells"][node[logged], ver[logged] - 1, 0]
    ncl[logged] = out["log_ncells"][node[logged], ver[logged] - 1]
    same = (logged & (rec[:, CELL_ROW] == writes["row"])
            & (rec[:, CELL_COL] == writes["col"])
            & (rec[:, CELL_VR] == writes["val"])
            & (rec[:, CELL_CL] == 1) & (ncl == 1))
    writes_wrong += int((logged & ~same).sum())

    # -- col_versions: exact where the draws fix them, elsewhere bounded
    # by the writer's own earlier write to the cell and by the writes to
    # the cell in earlier rounds
    cv = rec[:, CELL_CV]
    rnd = writes["round"].astype(np.int64)
    pinned, prior = cv_pinned(writes, num_nodes=n, num_cols=cols)
    bad = same & ((cv < 1) | (cv > 1 + prior) | (cv >= CV_LIMIT)
                  | (pinned & (cv != 1 + prior)))
    own = np.lexsort((rnd, cell, node))
    nxt = own[1:]
    prv = own[:-1]
    repeat = (node[nxt] == node[prv]) & (cell[nxt] == cell[prv])
    bad[nxt[repeat & same[nxt] & same[prv] & (cv[nxt] <= cv[prv])]] = True
    cv_wrong = int(bad.sum())

    # -- the LWW winner of each cell, over the recorded writes
    ok = same & ~bad
    key = np.where(ok, lww_key(np.clip(cv, 0, CV_LIMIT - 1),
                               writes["val"], node), -1)
    win = np.full(cells, -1, np.int64)
    np.maximum.at(win, cell, key)
    win_at = np.full(cells, -1, np.int64)  # the winning write's index
    is_win = ok & (key == win[cell])
    win_at[cell[is_win]] = np.nonzero(is_win)[0]

    # -- heads: no node holds a version nobody wrote, every writer holds
    # its own writes, and at convergence every live node holds them all
    head = out["head"]
    heads_wrong = int((head > count[None, :]).sum()) + int(
        (head < 0).sum())
    heads_wrong += int((np.diagonal(head) != count).sum())
    if converge:
        heads_wrong += int((head != count[None, :]).sum(axis=1)[alive_end]
                           .sum())

    # -- cell planes, at every node: each stored triple is a write to
    # that cell (or nothing), no lower than the node's own writes to it,
    # no higher than the cell's winner, and the winner itself wherever
    # the node's head covers the winner's version
    cvp = out["cv"].reshape(n, cells).astype(np.int64)
    vrp = out["vr"].reshape(n, cells).astype(np.int64)
    stp = out["site"].reshape(n, cells).astype(np.int64)
    empty = (cvp == 0) & (vrp == NEG) & (stp == -1)
    in_range = ((cvp >= 1) & (cvp < CV_LIMIT) & (vrp >= 0)
                & (vrp < (1 << VAL_BITS)) & (stp >= 0) & (stp < n))
    stored = np.where(in_range, lww_key(np.where(in_range, cvp, 0),
                                        np.where(in_range, vrp, 0),
                                        np.where(in_range, stp, 0)), -1)
    uniq = np.unique(key[ok])
    width = uniq.size + 1
    # (cell, key) pairs of every recorded write; sentinels past the ends
    pairs = np.sort(cell[ok] * width + np.searchsorted(uniq, key[ok]))
    pos = np.searchsorted(uniq, stored)
    known = np.append(uniq, -2)[pos] == stored
    code = np.arange(cells)[None, :] * width + pos
    at = np.searchsorted(pairs, code)
    member = known & (np.append(pairs, -1)[at] == code)
    wrong = ~(empty | (in_range & member))
    own_max = np.full((n, cells), -1, np.int64)
    np.maximum.at(own_max, (node[ok], cell[ok]), key[ok])
    wrong |= stored < own_max
    wrong |= stored > win[None, :]
    has_win = win_at >= 0
    w_node = node[np.maximum(win_at, 0)]
    w_ver = ver[np.maximum(win_at, 0)]
    covered = has_win[None, :] & (head[:, w_node] >= w_ver[None, :])
    wrong |= covered & (stored != win[None, :])
    cells_wrong = int(wrong.sum())
    # causal lengths: 1 on a row that holds a cell, 0 on a row that was
    # never written, nothing else (no deletes)
    cl = out["cl"].astype(np.int64)
    holds = (~empty).reshape(n, num_rows, cols).any(axis=2)
    ever = np.zeros(num_rows, bool)
    ever[writes["row"]] = True
    cells_wrong += int(((cl != 0) & (cl != 1)).sum()
                       + ((cl == 0) & holds).sum()
                       + ((cl == 1) & ~ever[None, :]).sum())
    if converge:
        want_cl = ever.astype(np.int64)
        cells_wrong += int((cl[alive_end] != want_cl[None, :]).sum())
    return {"writes_wrong": writes_wrong, "cv_wrong": cv_wrong,
            "heads_wrong": heads_wrong, "cells_wrong": cells_wrong}


def rounds_wrong(converged_round, rounds: int, *, chunk: int,
                 min_rounds: int, converge: bool, fixed_rounds=None) -> int:
    """1 when the run's round count contradicts its mode: a converged
    round outside the last chunk run or not past ``min_rounds``, or a
    fixed run of the wrong length; else 0."""
    if not converge:
        return int(rounds != fixed_rounds)
    if converged_round is None:
        return 1
    return int(not (min_rounds < converged_round <= rounds
                    and converged_round > rounds - chunk))


def lww_outputs(writes: dict, *, num_nodes: int, num_rows: int,
                num_cols: int) -> dict:
    """The outputs a converged cluster must hold, worked out from its
    writes alone: every node holds every write. Col_versions are the
    largest the bounds allow (one more than the writes to the cell in
    earlier rounds). The control reads these in the program's place."""
    n, cols = num_nodes, num_cols
    cells = num_rows * cols
    node = writes["node"].astype(np.int64)
    ver, count = versions(node, n)
    cell = writes["row"].astype(np.int64) * cols + writes["col"]
    cv = 1 + cv_pinned(writes, num_nodes=n, num_cols=cols)[1]
    h = max(int(count.max()) if count.size else 0, 1)
    log_cells = np.zeros((n, h, 1, 5), np.int32)
    log_cells[node, ver - 1, 0] = np.stack(
        [writes["row"], writes["col"], writes["val"], cv,
         np.ones_like(cv)], axis=1)
    log_ncells = np.zeros((n, h), np.int32)
    log_ncells[node, ver - 1] = 1
    key = lww_key(cv, writes["val"], node)
    win = np.full(cells, -1, np.int64)
    np.maximum.at(win, cell, key)
    has = win >= 0
    plane = lambda v, empty: np.broadcast_to(  # noqa: E731
        np.where(has, v, empty).astype(np.int32), (n, cells)).reshape(
            n, num_rows, cols)
    cl = np.zeros(num_rows, np.int32)
    cl[writes["row"]] = 1
    return {
        "cv": plane(win >> (VAL_BITS + SITE_BITS), 0),
        "vr": plane((win >> SITE_BITS) & ((1 << VAL_BITS) - 1), NEG),
        "site": plane(win & ((1 << SITE_BITS) - 1), -1),
        "cl": np.broadcast_to(cl, (n, num_rows)),
        "head": np.broadcast_to(count.astype(np.int32), (n, n)),
        "log_head": count.astype(np.int32),
        "log_cells": log_cells,
        "log_ncells": log_ncells,
    }
