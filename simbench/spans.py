"""The program's own ranges in a traced window.

While a ``torch.profiler`` records, the port opens ``corro.``-prefixed
ranges on the profiler's clock (``corro_sim_torch/utils/tracing.py``):
``corro.step`` around a round and, inside it, the sibling stages
``corro.step.<stage>`` (``engine/step.py``); ``corro.chunk_dispatch``,
``corro.chunk.<phase>`` and the tracer's other spans in the driver
(``engine/driver.py``). A program that lacks them (an older checkout)
opens none, and a reader here then reads nothing.

A metric reads a program range through the harness's ``RANGES``, which
names each range the first reduction (``trace.reduce_trace``) credits
launches to, and the function the harness wraps in it.
:func:`program_ranges` maps a program range to :func:`program_range`,
which nothing calls: the harness's wrapper on it wraps nothing that
runs, so the reduction sees the program's range alone. The reduction
credits a launch to the innermost listed range, and the harness's own
ranges (``simbench.<function>``) lie inside the program's stages: a
stage's reading adds back the ones inside it (``inner``).

:func:`idle_by_range` labels the device's idle gaps by the innermost
program range at each gap's middle, for a look at where the card waits
by stage rather than by host op.
"""

from __future__ import annotations

import bisect

from simbench import trace as trace_mod

PREFIX = "corro."
STEP = "corro.step"
NO_RANGE = "(no program range)"


def program_range() -> None:
    """Never called: the function a program range's ``RANGES`` entry
    names."""


def program_ranges(*names: str) -> dict:
    """``RANGES`` for program ranges: each of ``names``, and
    ``corro.step`` (which tells whether the program opens any)."""
    return {n: ("simbench.spans", "program_range")
            for n in dict.fromkeys((STEP,) + names)}


def has_program_ranges(run) -> bool:
    """Whether the traced window holds work inside a program range."""
    rng = (run.trace or {}).get("range_us", {})
    return any(us > 0 for name, us in rng.items() if name.startswith(PREFIX))


def stage_ms(run, name: str, inner=()):
    """Device milliseconds per traced round launched inside the program's
    ``name`` ranges, with the harness's ranges in ``inner`` (which lie
    inside them) added back; None without a trace or program ranges."""
    if not run.trace or not run.traced_rounds or not has_program_ranges(run):
        return None
    rng = run.trace["range_us"]
    us = rng.get(name, 0.0) + sum(rng.get(r, 0.0) for r in inner)
    return us / 1000.0 / run.traced_rounds


def range_names(events: list, prefix: str = PREFIX) -> list:
    """The names of the ranges in ``events`` that start with ``prefix``."""
    return sorted({e.get("name", "") for e in events
                   if e.get("cat") == trace_mod.RANGE_CAT
                   and e.get("name", "").startswith(prefix)})


def idle_by_range(events: list, ranges) -> dict:
    """``{range: us}``: the device's idle time in the window, each gap
    labelled by the innermost of ``ranges`` open on the driving thread
    at the gap's middle (``NO_RANGE`` where none is)."""
    if not events:
        return {}
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy = trace_mod._union([(e["ts"], e["ts"] + e["dur"]) for e in events
                             if e.get("cat") in trace_mod.DEVICE_CATS])
    main = trace_mod._main_thread(events)
    wanted = set(ranges)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if (e.get("pid"), e.get("tid")) == main
                   and e.get("cat") == trace_mod.RANGE_CAT
                   and e.get("name") in wanted)
    starts = [s[0] for s in spans]
    reach = []  # the latest end among spans[:i + 1]
    for s in spans:
        reach.append(max(s[1], reach[-1]) if reach else s[1])
    idle: dict = {}
    cursor = t0
    for s, e in busy + [(t1, t1)]:
        if s > cursor:
            mid = (cursor + s) / 2.0
            label = NO_RANGE
            # ranges nest: the latest-starting one that covers mid
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and reach[i] >= mid:
                if spans[i][1] >= mid:
                    label = spans[i][2]
                    break
                i -= 1
            idle[label] = idle.get(label, 0.0) + (s - cursor)
        cursor = max(cursor, e)
    return idle
