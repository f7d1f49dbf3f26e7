"""The sync sweep's grouped LWW merge as a share of its memory roofline.

Sample: the first ``calls`` merges of the sync sweep after the clean
traced window, in the same cluster. For each, the bytes the merge needs
on its inputs and outputs (``simbench/work.py``, a frozen copy of the
program's ``merge_work``) over the HBM's 3.35 TB/s, against the device
time of the merge kernel's slices (by name) in a trace of those calls.
The count holds whatever implements the merge; an implementation whose
kernel has another name reads nothing until this file names it."""

from simbench.work import HBM_BYTES_PER_S, merge_bytes

UNIT = "%"
LAYER = "merge kernel (core/csrc/merge_kernel.cu)"
MOVES = "round_ms"
SOURCE = "device_trace"
SAMPLE = {"target": ("corro_sim_torch.sync.sync", "merge_grouped"),
          "calls": 4, "kernel": "grouped_merge_kernel"}


def sample_call(fn, args, kwargs):
    """Run one merge, returning its result and the bytes it needs."""
    state, lanes, cap = args[0], args[1], args[2]
    n, rows, cols = state.cv.shape
    before = tuple(t.reshape(n, rows * cols).clone()
                   for t in (state.cv, state.vr, state.site))
    before += (state.cl.clone(),)
    out = fn(*args, **kwargs)
    after = tuple(t.reshape(n, rows * cols)
                  for t in (out.cv, out.vr, out.site)) + (out.cl,)
    return out, merge_bytes(before, lanes, int(cap), cols, after)


def read(run):
    works = run.sample_work.get("merge_roofline_pct") or []
    n, us = run.sample_kernel_us(SAMPLE["kernel"])
    if not works or n == 0 or us <= 0:
        return None
    return 100.0 * (sum(works) / HBM_BYTES_PER_S) / (us / 1e6)
