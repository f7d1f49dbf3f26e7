"""The reduction from a ``torch.profiler`` Chrome trace to the numbers the
per-layer metrics read.

The arithmetic follows ``corro_sim_torch/obs/profile.py::parse_trace``
(device work is the ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
slices; the host's dispatch is its ``cudaLaunchKernel`` slices), frozen
here so that a change to the program cannot change the yardstick. It
adds what that parser does not give: the device's busy time as the
union of its slices, the device time of the work launched inside a
named host range, and the device's idle time labelled by what the host
was doing meanwhile.
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CAT = "cuda_runtime"
RANGE_CAT = "user_annotation"
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
NO_HOST_OP = "(no host op)"


def load_events(path: str) -> list:
    """The complete (``ph: "X"``) events of a Chrome trace file."""
    with open(path, "rb") as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"
            and isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("dur"), (int, float))]


def _union(intervals: list) -> list:
    """Merged ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _main_thread(events: list):
    """The host thread that made the most runtime calls: the one that
    drives the card."""
    counts: dict = {}
    for e in events:
        if e.get("cat") == RUNTIME_CAT:
            key = (e.get("pid"), e.get("tid"))
            counts[key] = counts.get(key, 0) + 1
    return max(counts, key=counts.get) if counts else None


def _correlation(e):
    args = e.get("args") or {}
    return args.get("correlation")


def reduce_trace(events: list, ranges=()) -> dict:
    """What the per-layer metrics read of one traced window.

    Returns ``window_us`` (the window, first to last slice), ``busy_us``
    (the union of the device's slices), ``kernels`` (kernel slices),
    ``dispatch_us`` (host time in the launch calls), ``by_name``
    (``{kernel: [count, us]}``), ``range_us`` (``{range: us}``: device
    time of the slices launched inside each host range named in
    ``ranges``) and ``idle_by_host`` (``{host op: us}``: the device's
    idle time, each gap labelled by the innermost host slice on the
    driving thread at the gap's middle)."""
    if not events:
        return {}
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    by_name: dict = {}
    for e in device:
        if e.get("cat") == "kernel":
            slot = by_name.setdefault(e.get("name", ""), [0, 0.0])
            slot[0] += 1
            slot[1] += e["dur"]
    main = _main_thread(events)
    on_main = [e for e in events if (e.get("pid"), e.get("tid")) == main]
    dispatch = sum(e["dur"] for e in on_main
                   if e.get("cat") == RUNTIME_CAT
                   and e.get("name") in LAUNCH_NAMES)

    # device time of the work launched inside each named host range
    wanted = set(ranges)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e.get("name"))
                   for e in on_main if e.get("cat") == RANGE_CAT
                   and e.get("name") in wanted)
    starts = [s[0] for s in spans]
    reach = []  # the latest end among spans[:i + 1]
    for s in spans:
        reach.append(max(s[1], reach[-1]) if reach else s[1])
    launch_range: dict = {}
    for e in on_main:
        if e.get("cat") != RUNTIME_CAT or _correlation(e) is None:
            continue
        # ranges may nest: the holder that started last is the innermost
        i = bisect.bisect_right(starts, e["ts"]) - 1
        while i >= 0 and reach[i] >= e["ts"]:
            if spans[i][1] >= e["ts"]:
                launch_range[_correlation(e)] = spans[i][2]
                break
            i -= 1
    range_us = {name: 0.0 for name in ranges}
    for e in device:
        name = launch_range.get(_correlation(e))
        if name is not None:
            range_us[name] += e["dur"]

    # idle gaps, each labelled by the innermost host slice at its middle
    gaps = []
    cursor = t0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if t1 > cursor:
        gaps.append((cursor, t1))
    host = sorted(((e["ts"], -e["dur"], e["ts"] + e["dur"],
                    e.get("name", "")) for e in on_main
                   if e.get("cat") in HOST_CATS))
    idle: dict = {}
    stack: list = []
    j = 0
    for gs, ge in gaps:  # gaps are sorted by start and disjoint
        mid = (gs + ge) / 2.0
        while j < len(host) and host[j][0] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        label = NO_HOST_OP
        for ev in reversed(stack):
            if ev[0] <= mid <= ev[2]:
                label = ev[3]
                break
        idle[label] = idle.get(label, 0.0) + (ge - gs)
    return {
        "window_us": t1 - t0,
        "busy_us": sum(e - s for s, e in busy),
        "kernels": sum(c for c, _ in by_name.values()),
        "dispatch_us": dispatch,
        "by_name": by_name,
        "range_us": range_us,
        "idle_by_host": idle,
    }


def kernel_us(events: list, fragment: str) -> tuple:
    """``(launches, us)`` of the kernel slices whose name holds
    ``fragment``."""
    n, us = 0, 0.0
    for e in events:
        if e.get("cat") == "kernel" and fragment in e.get("name", ""):
            n += 1
            us += e["dur"]
    return n, us


def breakdown(red: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time, and the idle time by what the host was doing, each in
    seconds."""
    ops = sorted(red.get("by_name", {}).items(), key=lambda kv: -kv[1][1])
    idle = sorted(red.get("idle_by_host", {}).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:160], v[1] / 1e6] for k, v in ops[:top]],
            "idle_gaps": [[k, v / 1e6] for k, v in idle[:top]]}
