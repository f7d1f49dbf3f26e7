"""One full-view SWIM tick as a share of its memory roofline.

Sample: the first tick after the clean traced window, in the same
cluster (the call the step makes, ``engine/step.py``'s ``swim_step``).
Its bytes are the least any correct tick moves on its shapes
(``simbench/swim_work.py``, frozen) over the HBM's 3.35 TB/s; its time
is the device time of every kernel in the sampled tick's trace, so the
count holds whatever implements SWIM. The harness reads kernel slices
only: a plain device-to-device copy the tick makes (a memcpy slice) is
not in the time."""

from simbench.reference.swim import Params, is_announce
from simbench.swim_work import tick_bytes
from simbench.work import HBM_BYTES_PER_S

UNIT = "%"
LAYER = "membership (membership/swim.py)"
MOVES = "round_ms"
SOURCE = "device_trace"
SAMPLE = {"target": ("corro_sim_torch.engine.step", "swim_step"),
          "calls": 1, "kernel": ""}


def sample_call(fn, args, kwargs):
    """Run one tick, returning its result and the bytes it needs."""
    cfg, swim, round_idx = args[0], args[1], int(args[5])
    rows, n = swim.p.shape
    params = Params.from_sim(cfg)
    out = fn(*args, **kwargs)
    return out, tick_bytes(n, rows, params.narrow, params.payload_members,
                           params.gossip_peers,
                           is_announce(params, round_idx))


def read(run):
    works = run.sample_work.get("swim_roofline_pct") or []
    n, us = run.sample_kernel_us(SAMPLE["kernel"])
    if not works or n == 0 or us <= 0:
        return None
    return 100.0 * (sum(works) / HBM_BYTES_PER_S) / (us / 1e6)
