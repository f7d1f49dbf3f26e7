"""Where a round of the port's main path spends its time.

    python -m corro_sim_torch.profile_slice [--swim | --config3 | --config6
                                             | --soak SPEC | --latency
                                             | --config8
                                             | --host-read PAIRS]
                                            [--out DIR]

Defines the slice's cells — the north-star cluster with SWIM off and,
with ``--swim``, exactly as the JAX package's config 0 (full-view SWIM,
narrow layout), its partition schedule and run arguments; and the JAX
package's config 3 (the Consul-schema cluster with multi-cell,
multi-chunk changesets); the batched half of the JAX package's config 6
(Zipf + churn-storm service-discovery traffic from the workload engine
under an egress cap); and the replay fixtures — which ``chip_smoke.py``
drives too, and the digest runs hold against the JAX package. Runs one
cell on the card from the same seed (``--config3``: config 3 at 1000
nodes over its first 128 rounds, ``CONFIG3_PROFILE_ARGS``: the write
phase, the drain and the start of the repair tail; ``--config6``: config
6 at 10 000 nodes over its first 128 rounds, ``CONFIG6_PROFILE_ARGS``:
the 64 load rounds and the drain; ``--soak SPEC``: config 0 at 10 000
nodes soaked under the fault scenario ``SPEC`` over its first 64
rounds, ``SOAK_PROFILE_ROUNDS``, with the soak CLI's arguments and no
checker — ``lossy:p=0`` is the fault-free twin of ``lossy:p=0.1``;
``--latency``: config 0 at 10 000 nodes across four latency regions with
RTT rings and 8 probes, to convergence, whose fault-free twin is
``--swim``):
once to warm the allocator and the kernel build (discarded), then three
times:

1. plain, timed — the wall per round a user sees;
2. with each stage of the step wrapped in a device synchronize and a
   host timer — the wall of each stage, inclusive of its launches
   (nested stages, such as the draws inside the sync sweep, count in
   both);
3. under ``torch.profiler`` — device time by kernel name, the number of
   kernels launched, the device's busy share of the profiled wall and,
   with SWIM on, the share of kernel launches made inside SWIM ticks;
4. with the sync sweep's merge wrapped — the merge kernel's in-place
   and out-of-place bounds (``merge_work``), its words counted in whole
   DRAM sectors (``merge_sector_bytes``) and what each real mailbox
   holds (valid lanes, rows hit, rows wiped), set beside the kernel's
   device time per launch from run 3.

Prints one JSON object and writes it, with the full kernel table, to
``DIR/profile_slice.json`` (``profile_slice_swim.json`` with ``--swim``,
``profile_slice_config3.json`` with ``--config3``,
``profile_slice_config6.json`` with ``--config6``,
``profile_slice_soak_<spec>.json`` with ``--soak``,
``profile_slice_latency.json`` with ``--latency``).

``--config8`` runs the JAX package's config 8 exactly instead (its 32
lanes through ``run_sweep`` in lockstep, then compacted at width 16 and
pipelined, and its first lane serially), to ``DIR/config8.json``.

``--host-read PAIRS`` measures instead the step's read of the sweep
gate's device predicate: copied to the host where it is computed and
read where the sweep is due (the step as it is), against a blocking
read where the sweep is due, end to end on config 0 and config 6 at
10 000 nodes, ``PAIRS`` pairs each, to ``DIR/host_read.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from corro_sim_torch import merge_probe as mp
from corro_sim_torch import prng
from corro_sim_torch.config import SimConfig
from corro_sim_torch.core import delivery as delivery_mod
from corro_sim_torch.core import merge_kernel as mk
from corro_sim_torch.engine import step as step_mod
from corro_sim_torch.convert import state_to_numpy
from corro_sim_torch.engine.driver import RunResult, Schedule, run_sim
from corro_sim_torch.engine.state import init_state
from corro_sim_torch.faults import (
    InvariantChecker,
    ResilienceScorecard,
    Scenario,
    make_scenario,
)
from corro_sim_torch.sync import sync as sync_mod
from corro_sim_torch.workload import Workload, make_workload

# (module, attribute) of each timed stage, as the step calls it
STAGES = (
    (step_mod, "local_write"),
    (step_mod, "append_changesets"),
    (step_mod, "update_ownership"),
    (step_mod, "broadcast_step"),
    (step_mod, "delivery_pass"),
    (step_mod, "enqueue_own"),
    (step_mod, "enqueue_broadcasts"),
    (step_mod, "sync_round"),
    (step_mod, "_gap"),
    (step_mod, "partial_versions"),  # 32 // cpv passes over the window
    (step_mod, "_swim_block"),  # SWIM tick rounds and skipped rounds
    (step_mod, "swim_step"),  # the SWIM tick alone
    (step_mod, "_fault_lane"),  # fault keys, burst state (link faults)
    (step_mod, "link_fault_masks"),  # the loss and dup draws at delivery
    (step_mod, "apply_node_faults"),  # wipes and snapshot captures
    (step_mod, "observe_rtt"),  # RTT samples (rtt_rings)
    (step_mod, "recompute_ring0"),  # the ring recomputation (rtt_rings)
    (step_mod, "probe_write_update"),  # probe origins (probes)
    (delivery_mod, "probe_delivery_update"),  # the probe merge point
    (step_mod, "_probe_after_sync"),  # probe sync joins and stamps
    (sync_mod, "_legacy_schedule"),  # the legacy sync schedule
    (sync_mod, "choose_sync_peers"),
    (sync_mod, "merge_grouped"),
    (sync_mod, "advance_heads"),
    (prng, "uniform"),
    (prng, "randint"),
    (prng, "choice"),
)


# run_sim arguments of the slice's cell: about 1 000 writes over 8
# rounds, convergence tested from round 16 on
RUN_ARGS = dict(max_rounds=512, chunk=16, seed=0, min_rounds=16)


def slice_config(n: int = 10000, merge_kernel: str = "auto",
                 swim: bool = False) -> SimConfig:
    """The north-star cluster, the JAX package's config 0
    (``corro_sim/benchmarks.py:237-282``), at ``n`` nodes: exactly, with
    full-view SWIM in the narrow layout, when ``swim``; else with SWIM off
    (the first slice's cell)."""
    swim_kw = dict(
        swim_enabled=True, swim_suspect_rounds=6, swim_interval=4,
        narrow_state=True,
    ) if swim else dict(swim_enabled=False)
    return SimConfig(
        num_nodes=n, num_rows=256, num_cols=4, log_capacity=512,
        write_rate=1000.0 / (n * 8), zipf_alpha=0.8, sync_interval=8,
        pend_slots=8, fanout=2, sync_adaptive=True, sync_floor_rounds=1,
        sync_actor_topk=128, sync_cap_per_actor=1, sync_req_actors=128,
        sync_need_sample=64, sync_deal_probes=0, merge_kernel=merge_kernel,
        **swim_kw,
    )


def sim_toml(cfg: SimConfig) -> str:
    """``cfg`` as the ``[sim]`` table of a config file that
    ``io/config_file.py::load_config`` (either package's) reads back to
    the same config: every scalar field that differs from its default.
    The nested fault, twin and sweep tables must be at their defaults."""
    base = SimConfig()
    for nested in ("faults", "node_faults", "twin", "sweep"):
        if getattr(cfg, nested) != getattr(base, nested):
            raise ValueError(f"sim_toml writes no [sim.{nested}] table")
    lines = ["[sim]"]
    for f in dataclasses.fields(SimConfig):
        v = getattr(cfg, f.name)
        if f.name in ("faults", "node_faults", "twin", "sweep") or (
                v == getattr(base, f.name)):
            continue
        if isinstance(v, bool):
            lines.append(f"{f.name} = {'true' if v else 'false'}")
        elif isinstance(v, (int, float)):
            lines.append(f"{f.name} = {v!r}")
        elif isinstance(v, str):
            lines.append(f"{f.name} = {json.dumps(v)}")
        else:
            raise ValueError(f"sim_toml cannot write {f.name} = {v!r}")
    return "\n".join(lines) + "\n"


def latency_config(n: int = 10000) -> SimConfig:
    """Config 0 (``slice_config(n, swim=True)``) across four regions: the
    latency model with ``latency_inter`` at its default 4 (a far lane
    delivers 3 rounds after emission, ``inflight_slots`` 3), RTT rings
    recomputed every 8 rounds and 8 probes: the multi-region cell."""
    return dataclasses.replace(
        slice_config(n, swim=True), latency_regions=4, latency_inter=4,
        rtt_rings=True, ring_update_interval=8, probes=8,
    )


def legacy_config(n: int = 10000, deal_probes: int = 0) -> SimConfig:
    """Config 0 (``slice_config(n, swim=True)``) on the legacy full-axis
    sync schedule (``sync_hot_actors=0``): the exact argmax serving
    assignment, or ``deal_probes`` deal probes."""
    return dataclasses.replace(
        slice_config(n, swim=True), sync_hot_actors=0,
        sync_deal_probes=deal_probes,
    )


# the slice-8 digest runs: (config, nodes), each under slice_schedule()
# and RUN_ARGS, to convergence
SLICE8_DIGEST_CASES = {
    f"{name}_{n}": (name, n)
    for name in ("latency", "legacy", "deal") for n in (256, 1000)
}


def writing_actors(cfg: SimConfig, schedule: Schedule, chunk: int,
                   seed: int = 0) -> np.ndarray:
    """The actors that commit at least one version in a sampler run of
    ``cfg`` under ``schedule`` (chunks of ``chunk`` rounds): the writer
    draw of each write round (``step._sample_writes``, the round key's
    first lane against ``write_rate``), replayed on the host."""
    n = cfg.num_nodes
    root = prng.PRNGKey(seed)
    wrote = np.zeros(n, bool)
    rate = torch.full((), cfg.write_rate, dtype=torch.float32)
    for r in range(schedule.write_rounds):
        ci, j = divmod(r, chunk)
        key = prng.split(prng.fold_in(root, ci), chunk)[j]
        k_write = prng.split(key, len(step_mod.STEP_KEY_STREAMS))[0]
        alive = schedule.slice(r, 1, n)[0][0]
        wrote |= (prng.uniform(k_write, (n,), "cpu") < rate).numpy() & alive
    return np.nonzero(wrote)[0].astype(np.int32)


def aim_probes(state, actors: np.ndarray) -> None:
    """Re-aim the state's probes, in place, at version 1 of ``actors``
    spread evenly over the given ids (the JAX package's documented way:
    replace ``actor``/``ver`` before running)."""
    k = state.probe.actor.shape[0]
    pick = actors[np.linspace(0, len(actors) - 1, k).round().astype(int)]
    state.probe.actor = torch.as_tensor(pick, device=state.probe.actor.device)


# the round at which each of those runs converges, as the JAX package's
# does (the run behind DIGESTS[case])
SLICE8_ROUNDS = {"latency_256": 34, "latency_1000": 23, "legacy_256": 37,
                 "legacy_1000": 35, "deal_256": 38, "deal_1000": 37}


def slice8_config(case: str) -> SimConfig:
    """The configuration of a ``SLICE8_DIGEST_CASES`` run."""
    name, n = SLICE8_DIGEST_CASES[case]
    if name == "latency":
        return latency_config(n)
    return legacy_config(n, deal_probes=2 if name == "deal" else 0)


# The Consul-services schema's table layout (the JAX package's
# TableLayout(parse_and_constrain(consul_schema_sql()),
# default_capacity=256)): two tables at 256 row slots each, six value
# columns. The port keeps it as a constant; a parity test holds it equal.
CONSUL_ROWS, CONSUL_COLS = 512, 6


def config3_config(n: int = 1000, merge_kernel: str = "auto") -> SimConfig:
    """The JAX package's config 3 (``corro_sim/benchmarks.py:567-593``,
    the realism configuration) at ``n`` nodes, exactly: the Consul
    schema's layout, zipf 1.1 hot rows, changesets of up to 4 cells
    gossiped as 2 chunks, full-view SWIM (wide layout, a tick every
    round), sync every 8 rounds with 16 actors per peer."""
    return SimConfig(
        num_nodes=n, num_rows=CONSUL_ROWS, num_cols=CONSUL_COLS,
        log_capacity=512, write_rate=0.5, zipf_alpha=1.1,
        seqs_per_version=4, chunks_per_version=2, swim_enabled=True,
        sync_interval=8, sync_actor_topk=16, merge_kernel=merge_kernel,
    )


def config3_schedule() -> Schedule:
    """Config 3's schedule: writes for 32 rounds, everybody up."""
    return Schedule(write_rounds=32)


# run_sim arguments of config 3, as the JAX package's _sim_report runs it
CONFIG3_RUN_ARGS = dict(max_rounds=4096, chunk=8, seed=0)

# the window of config 3 that --config3 profiles: the 32 write rounds,
# the drain and the start of the repair tail
CONFIG3_PROFILE_ARGS = dict(max_rounds=128, chunk=8, seed=0,
                            stop_on_convergence=False)

# The JAX package's config 6, batched half (corro_sim/benchmarks.py:
# 800-834): Zipf + churn-storm traffic over 2048 service keys, 64 load
# rounds from seed 0, at 10 000 nodes by default.
CONFIG6_SPEC = ("zipf:alpha=1.1,rate=0.3,keys=2048"
                "+churn_storm:waves=6,batch=64,keys=2048")
CONFIG6_LOAD_ROUNDS = 64


def config6_workload(n: int = 10000) -> Workload:
    """Config 6's write schedule for ``n`` nodes."""
    return make_workload(CONFIG6_SPEC, n, rounds=CONFIG6_LOAD_ROUNDS, seed=0)


def config6_config(n: int = 10000, merge_kernel: str = "auto") -> SimConfig:
    """Config 6's batched half at ``n`` nodes, exactly: one row slot per
    key the schedule touches (at least 256), two columns, an egress cap
    of 4 of 8 ring slots per round, fanout 3, adaptive sync every 4
    rounds. At 256 and 1000 nodes the schedule touches 2046 keys (4092
    cells, not a multiple of 128, so every merge takes the scatter arm);
    at 10 000 nodes 2048 (4096 cells: the kernel runs)."""
    return SimConfig(
        num_nodes=n, num_rows=max(config6_workload(n).key_universe(), 256),
        num_cols=2, log_capacity=max(2 * CONFIG6_LOAD_ROUNDS, 256),
        pend_slots=8, emit_slots=4, fanout=3, sync_interval=4,
        sync_adaptive=True, merge_kernel=merge_kernel,
    )


# run_sim arguments of config 6, as the JAX package's run_config_6 runs it
CONFIG6_RUN_ARGS = dict(max_rounds=4096, chunk=8, seed=0)
# the round at which config 6 converges at 1000 nodes from seed 0, as the
# JAX package's run does (the run behind DIGESTS["config6_1000"])
CONFIG6_ROUNDS = 155
# the window of config 6 that --config6 profiles: the load and the drain
CONFIG6_PROFILE_ARGS = dict(max_rounds=128, chunk=8, seed=0,
                            stop_on_convergence=False)

# The JAX package's config 4, the headline (corro_sim/benchmarks.py:
# 106-195, run_headline_bench): 10 000 nodes, 256 x 4 cells, writes at
# rate 0.5 in every round, wide full-view SWIM ticking every round, the
# upper half partitioned in rounds 16-31, lean sync every 8 rounds.
def config4_config(n: int = 10000, merge_kernel: str = "auto") -> SimConfig:
    """``run_headline_bench``'s SimConfig at ``n`` nodes, exactly."""
    return SimConfig(
        num_nodes=n, num_rows=256, num_cols=4, log_capacity=512,
        write_rate=0.5, zipf_alpha=0.8, swim_enabled=True,
        swim_suspect_rounds=6, sync_interval=8, sync_actor_topk=32,
        sync_cap_per_actor=8, sync_req_actors=32, sync_need_sample=64,
        merge_kernel=merge_kernel,
    )


def partition_upper_half_16_32(r: int, num: int) -> np.ndarray:
    """Config 4's partition: the upper half cut off for rounds 16-31."""
    p = np.zeros(num, np.int32)
    if 16 <= r < 32:
        p[num // 2:] = 1
    return p


def config4_schedule() -> Schedule:
    """Config 4's schedule: writes in every round, the mid-run cut."""
    return Schedule(write_rounds=10**9, part_fn=partition_upper_half_16_32)


# run_sim arguments of config 4: the JAX package's warm-up chunk and its
# 4 measured chunks of 8 rounds walk the same keys and schedule rows
CONFIG4_RUN_ARGS = dict(max_rounds=40, chunk=8, seed=0,
                        stop_on_convergence=False)
CONFIG4_MEASURED_CHUNKS = (1, 2, 3, 4)


def config4_rate(chunk_walls: dict, metrics: dict, chunk: int = 8) -> float:
    """The headline, ``crdt_changes_applied_per_sec_<n>_node_sim``: the
    median over the measured chunks of ``(writes + fresh +
    sync_versions) / chunk wall``; ``chunk_walls`` maps a chunk index to
    its wall in seconds (``run_sim``'s ``on_chunk``)."""
    applied = metrics["writes"] + metrics["fresh"] + metrics["sync_versions"]
    rates = [
        float(applied[ci * chunk:(ci + 1) * chunk].sum()) / chunk_walls[ci]
        for ci in CONFIG4_MEASURED_CHUNKS
    ]
    return float(np.median(rates))


def state_bytes(cfg: SimConfig) -> int:
    """Bytes of ``init_state(cfg)``'s tensors, counted on the meta device
    (nothing is allocated)."""
    from corro_sim_torch.engine.state import state_nbytes

    return state_nbytes(init_state(cfg, seed=0, device="meta"))


# The JAX package's config 5, catch-up after an outage (corro_sim/
# benchmarks.py:601-748): 30 % of the nodes down through 24 write rounds
# at rate 0.2, then back; adaptive sync every round with an 8192-actor hot
# window, 512 actors x 16 versions per peer (8192 mailbox lanes per node).
CONFIG5_WRITE_ROUNDS = 24
CONFIG5_OUTAGE = 0.3
CONFIG5_TARGET_NODES = 50000
CONFIG5_COMPUTE_CAP = 16384


def config5_config(n: int = CONFIG5_COMPUTE_CAP,
                   merge_kernel: str = "auto") -> SimConfig:
    """``config5_cfg(n)``, exactly."""
    return SimConfig(
        num_nodes=n, num_rows=128, num_cols=2, log_capacity=256,
        write_rate=0.2, swim_enabled=False, sync_interval=4,
        sync_adaptive=True, sync_floor_rounds=1, sync_peers=4,
        sync_actor_topk=512, sync_cap_per_actor=16, sync_req_actors=512,
        sync_hot_actors=8192, merge_kernel=merge_kernel,
    )


def config5_schedule(n: int) -> Schedule:
    """The lowest 30 % of the nodes are down for the write rounds."""
    down = np.arange(n) < int(n * CONFIG5_OUTAGE)

    def alive_fn(r: int, num: int) -> np.ndarray:
        return ~down if r < CONFIG5_WRITE_ROUNDS else np.ones(num, bool)

    return Schedule(write_rounds=CONFIG5_WRITE_ROUNDS, alive_fn=alive_fn)


# run_config_5's run_sim arguments
CONFIG5_RUN_ARGS = dict(max_rounds=4096, chunk=8, seed=0,
                        min_rounds=CONFIG5_WRITE_ROUNDS + 1)


def size_config5(device_bytes: int) -> tuple:
    """``(nodes, reason)``: the JAX package's one-device sizing of config
    5 (``benchmarks.py:659-678``): the 50 000-node target capped at 16 384
    (one device runs the whole cluster's compute), then halved while the
    state plus ~3 (N, A) int32 sweep temporaries (12 N^2 bytes) exceed
    85 % of ``device_bytes``. ``reason`` names the limit that bound."""
    nodes, reason = CONFIG5_TARGET_NODES, None
    if nodes > CONFIG5_COMPUTE_CAP:
        nodes = CONFIG5_COMPUTE_CAP
        reason = "compute-time cap (one device runs the whole cluster)"
    budget = int(0.85 * device_bytes)
    while nodes > 1024:
        if state_bytes(config5_config(nodes)) + 12 * nodes * nodes <= budget:
            break
        nodes //= 2
        reason = "device memory budget"
    return nodes, reason


# The JAX package's config 7 in its one-device form (corro_sim/
# benchmarks.py:930-1009): one device's share of the 100 000-node,
# 8-device target; windowed SWIM (a view of 128, a tick every 4 rounds),
# 8 write rounds, config 5's sync. shard_log=True places the change log
# across devices; on one device it changes nothing.
CONFIG7_TARGET_NODES = 100000
CONFIG7_WRITE_ROUNDS = 8


def config7_config(n: int = CONFIG7_TARGET_NODES // 8,
                   merge_kernel: str = "auto") -> SimConfig:
    """``config7_cfg(n)``, exactly."""
    return SimConfig(
        num_nodes=n, num_rows=128, num_cols=2, log_capacity=256,
        write_rate=0.2, swim_enabled=True, swim_view_size=128,
        swim_interval=4, sync_interval=4, sync_adaptive=True,
        sync_floor_rounds=1, sync_peers=4, sync_actor_topk=512,
        sync_cap_per_actor=16, sync_req_actors=512, sync_hot_actors=8192,
        shard_log=True, merge_kernel=merge_kernel,
    )


def config7_schedule() -> Schedule:
    return Schedule(write_rounds=CONFIG7_WRITE_ROUNDS)


# run_config_7's run_sim arguments
CONFIG7_RUN_ARGS = dict(max_rounds=2048, chunk=8, seed=0,
                        min_rounds=CONFIG7_WRITE_ROUNDS + 1)


def size_config7(device_bytes: int) -> tuple:
    """``(nodes, reason)``: config 7's one-device sizing
    (``benchmarks.py:986-1009``): one device's eighth of the 100 000-node
    target, then halved while the state plus ~3 dense (N, 8192) int32
    sweep temporaries exceed 85 % of ``device_bytes``."""
    nodes = max(CONFIG7_TARGET_NODES // 8, 1024)
    reason = "weak-scaling share (1 device(s) run 1/8 of the 8-device target)"
    budget = int(0.85 * device_bytes)
    while nodes > 1024:
        if state_bytes(config7_config(nodes)) + 12 * nodes * 8192 <= budget:
            break
        nodes //= 2
        reason = "device memory budget"
    return nodes, reason


# The whole-run digests of this slice's configurations at sizes the JAX
# package runs on the CPU: config 4 over its 40 rounds at 1024 nodes;
# config 5's and config 7's shapes at 2048 and 1536 nodes with a
# 1024-actor hot window (their 8192 would cover every actor at these
# sizes, so the window would never rotate; 2048 keeps config 5's 2:1
# nodes-to-window ratio), to convergence; config 6 at 4000 nodes, to
# convergence (where its 1024-actor window rotates).
CONFIG_DIGEST_HOT_ACTORS = 1024


def config_digest_case(case: str) -> dict:
    """The run behind ``DIGESTS[case]`` for the configuration digests:
    ``cfg``, ``schedule``, ``run_args``, ``workload`` and the metrics the
    digest leaves out (``exclude``)."""
    name, n = case.split("_")
    n = int(n)
    hot = dict(sync_hot_actors=CONFIG_DIGEST_HOT_ACTORS)
    if name == "config4":
        # config 4's lag sums pass 2**24 (ROADMAP.md queue 3, the gap)
        return dict(cfg=config4_config(n), schedule=config4_schedule(),
                    run_args=CONFIG4_RUN_ARGS, workload=None,
                    exclude=("gap",))
    if name == "config5":
        return dict(cfg=dataclasses.replace(config5_config(n), **hot),
                    schedule=config5_schedule(n), run_args=CONFIG5_RUN_ARGS,
                    workload=None, exclude=())
    if name == "config7":
        return dict(cfg=dataclasses.replace(config7_config(n), **hot),
                    schedule=config7_schedule(), run_args=CONFIG7_RUN_ARGS,
                    workload=None, exclude=())
    if name == "config6":
        return dict(cfg=config6_config(n), schedule=Schedule(),
                    run_args=CONFIG6_RUN_ARGS, workload=config6_workload(n),
                    exclude=CONFIG6_DIGEST_EXCLUDE)
    raise ValueError(f"no configuration digest case {case!r}")


CONFIG_DIGEST_CASES = ("config4_1024", "config5_2048", "config7_1536",
                       "config6_4000")
# the rounds at which those runs converge, as the JAX package's do
# (config 4 runs its 40 rounds without a convergence stop)
CONFIG_DIGEST_ROUNDS = {"config4_1024": None, "config5_2048": 37,
                        "config7_1536": 19, "config6_4000": 474}



def soak_config(n: int = 10000) -> SimConfig:
    """Config 0's SimConfig (the north-star cluster of
    ``corro_sim/benchmarks.py:237-282``: full-view SWIM, narrow layout)
    at ``n`` nodes: the soak's cluster at the project's target scale."""
    return slice_config(n, swim=True)


def config8_lane_config(n: int = 256) -> SimConfig:
    """Config 8's per-lane base (``corro_sim/benchmarks.py:1106-1110``):
    ``n`` nodes, max(64, n / 4) rows of 2 cells, log capacity 256, write
    rate 0.3, SWIM (full view below 1024 nodes, else a view of 64), a
    sync every 4 rounds."""
    return SimConfig(
        num_nodes=n, num_rows=max(64, n // 4), num_cols=2,
        log_capacity=256, write_rate=0.3, swim_enabled=True,
        swim_view_size=(64 if n >= 1024 else 0), sync_interval=4,
    ).validate()


# the JAX package's soak CLI defaults (corro_sim/cli.py, `soak`)
SOAK_ARGS = dict(rounds=128, write_rounds=16, chunk=16, max_rounds=4096)
# config 8's lane runs (corro_sim/benchmarks.py:1111-1114): 96 scenario
# rounds, 16 write rounds, chunks of 16, at most 1024 rounds
CONFIG8_SOAK_ARGS = dict(rounds=96, write_rounds=16, chunk=16,
                         max_rounds=1024)


@dataclasses.dataclass
class SoakRun:
    """One scenario's soak run: the run, its armed checkers, the
    compiled scenario and the config it ran."""

    result: RunResult
    invariants: InvariantChecker | None
    scenario: Scenario
    cfg: SimConfig


def run_soak(cfg: SimConfig, spec: str, rounds: int = 128,
             write_rounds: int = 16, chunk: int = 16,
             max_rounds: int = 4096, seed: int = 0, device=None,
             invariants: bool = True, scorecard: bool | None = None,
             **run_kw) -> SoakRun:
    """One pass of the JAX package's serial soak loop
    (``corro_sim/cli.py:591-640``): ``make_scenario(spec, n, rounds,
    write_rounds, seed)``, ``cfg`` with the scenario's knobs, an
    invariant checker (``invariants``), a resilience scorecard
    (``scorecard``; None arms it on node-fault scenarios, as the soak
    does), and ``run_sim`` from ``init_state(cfg, seed)`` with
    ``min_rounds=max(heal_round, write_rounds)``. ``run_kw`` goes to
    ``run_sim`` (``stop_on_convergence``, ``pipeline``, ...)."""
    sc = make_scenario(spec, cfg.num_nodes, rounds=rounds,
                       write_rounds=write_rounds, seed=seed)
    cfg = sc.apply(cfg)
    inv = InvariantChecker(cfg) if invariants else None
    if scorecard is None:
        scorecard = cfg.node_faults.enabled
    card = ResilienceScorecard(cfg, scenario=sc) if scorecard else None
    res = run_sim(
        cfg, init_state(cfg, seed=seed, device=device), sc.schedule(),
        max_rounds=max_rounds, chunk=chunk, seed=seed,
        min_rounds=max(sc.heal_round or 0, write_rounds), device=device,
        invariants=inv, scorecard=card, **run_kw,
    )
    return SoakRun(result=res, invariants=inv, scenario=sc, cfg=cfg)


def fault_digest_run(case: str, device=None, **run_kw) -> SoakRun:
    """The run behind ``DIGESTS["soak:<case>"]`` (``"<spec>@<seed>"``, or
    ``"<spec>@<seed>+latency"`` on the lane base across four latency
    regions)."""
    name, _, variant = case.partition("+")
    spec, seed = name.rsplit("@", 1)
    cfg = config8_lane_config()
    if variant == "latency":
        cfg = dataclasses.replace(cfg, latency_regions=4)
    args = dict(CONFIG8_SOAK_ARGS)
    if case in FAULT_FIXED_ROUNDS:
        args["max_rounds"] = FAULT_FIXED_ROUNDS[case]
        run_kw.setdefault("stop_on_convergence", False)
    return run_soak(cfg, spec, seed=int(seed), device=device, **args,
                    **run_kw)


def fault_digest_record(case: str, run: SoakRun) -> dict:
    """A fault digest run's outcome beside its JAX pin: the digest, the
    rounds, the converged round, the invariant violations and the
    resilience integers, and whether each matches."""
    res = run.result
    want_rounds, want_conv, want_viol, want_res = FAULT_PINS[case]
    viol = [(v.round, v.invariant) for v in run.invariants.violations]
    got_res = (None if res.resilience is None else
               tuple(res.resilience[k] for k in RESILIENCE_INTS))
    digest = run_digest(state_to_numpy(res.state), res.metrics)
    rec = {"rounds": res.rounds, "converged_round": res.converged_round,
           "digest": digest, "violations": viol, "resilience": got_res,
           "invariants_ok": run.invariants.ok}
    rec["match"] = (
        digest == DIGESTS[f"soak:{case}"] and res.rounds == want_rounds
        and res.converged_round == want_conv and viol == want_viol
        and got_res == want_res
    )
    return rec

# config 8's serial soak (corro_sim/benchmarks.py:1106-1114, cli.py's
# serial loop): each scenario at seeds 0 and 1 on the lane base
CONFIG8_SCENARIOS = ("lossy:p=0.1", "churn:rate=0.05", "crash_amnesia",
                     "clock_skew")
# the other scenarios of the JAX package's SOAK_DEFAULT, at seed 0
SOAK_OTHERS = ("duplicating", "burst", "rolling_restart", "flapper",
               "split_brain_heal", "stale_rejoin", "stragglers")
# lossy links under the latency ring: the ring's conservation counters
LATENCY_SOAK_CASE = "lossy:p=0.1@0+latency"
FAULT_DIGEST_CASES = tuple(
    [f"{spec}@{seed}" for seed in (0, 1) for spec in CONFIG8_SCENARIOS]
    + [f"{spec}@0" for spec in SOAK_OTHERS] + ["blackhole_one_way@0",
                                               LATENCY_SOAK_CASE]
)
# config 8's scenarios at seed 0: the serial twins of config 8's seed-0
# sweep lanes, which chip_smoke.py runs in its "config8_sweep" phase
CONFIG8_SERIAL_CASES = tuple(f"{spec}@0" for spec in CONFIG8_SCENARIOS)
# the cases chip_smoke.py's "fault_digests" phase runs: the other
# scenarios once, at seed 0
FAULT_DIGEST_CHIP_CASES = tuple(c for c in FAULT_DIGEST_CASES
                                if "@1" not in c
                                and c not in CONFIG8_SERIAL_CASES)
# blackhole_one_way never re-converges (the hole never heals): a fixed
# 96 rounds
FAULT_FIXED_ROUNDS = {"blackhole_one_way@0": 96}
RESILIENCE_INTS = ("heal_round", "recovery_rounds", "rows_lost",
                   "resync_rows", "wipes", "wipes_observed",
                   "swim_false_down", "swim_flaps", "chunks_checked")

# What the JAX package's run of each fault digest case reports (the run
# behind DIGESTS["soak:<case>"]): (rounds run, converged round, the
# invariant violations as (round, invariant), and the resilience
# block's RESILIENCE_INTS, or None where the soak arms no scorecard).
# split_brain_heal's SWIM false-DOWN is the JAX package's own verdict
# (ROADMAP.md queue 3), which the port must reproduce.
FAULT_PINS = {
    "lossy:p=0.1@0": (64, 60, [],
                     None),
    "churn:rate=0.05@0": (80, 72, [],
                         None),
    "crash_amnesia@0": (64, 56, [],
                       (12, 44, 0, 3702, 3, 3, 13, 0, 4)),
    "clock_skew@0": (64, 56, [],
                    (15, 41, 0, 0, 0, 0, 0, 0, 4)),
    "lossy:p=0.1@1": (64, 60, [],
                     None),
    "churn:rate=0.05@1": (80, 72, [],
                         None),
    "crash_amnesia@1": (64, 56, [],
                       (12, 44, 0, 3786, 3, 3, 36, 0, 4)),
    "clock_skew@1": (64, 56, [],
                    (15, 41, 0, 0, 0, 0, 0, 0, 4)),
    "duplicating@0": (64, 60, [],
                     None),
    "burst@0": (64, 60, [],
               None),
    "rolling_restart@0": (80, 68, [],
                         None),
    "flapper@0": (80, 68, [],
                 None),
    "split_brain_heal@0": (80, 76, [(63, 'swim_false_down')],
                          None),
    "stale_rejoin@0": (64, 60, [],
                      (12, 48, 0, 2250, 2, 2, 0, 0, 4)),
    "stragglers@0": (144, 140, [],
                    (15, 125, 0, 0, 0, 0, 0, 0, 9)),
    "blackhole_one_way@0": (96, None, [],
                           None),
    LATENCY_SOAK_CASE: (80, 68, [], None),
}


# ---------------------------------------------------- config 8's sweep
# config 8 exactly (corro_sim/benchmarks.py:1073-1258): config 8's lane
# base under its four scenarios × seeds, raced by run_sweep with
# scorecards and invariant checkers armed
CONFIG8_PLAN_ARGS = dict(rounds=96, write_rounds=16)
CONFIG8_SWEEP_ARGS = dict(max_rounds=1024, chunk=16)


def config8_plan(seeds, n: int = 256, scenarios=CONFIG8_SCENARIOS):
    """Config 8's sweep plan: ``build_plan`` of the lane base at ``n``
    nodes over ``scenarios`` × ``seeds``."""
    from corro_sim_torch.sweep import build_plan

    return build_plan(config8_lane_config(n), list(scenarios), list(seeds),
                      **CONFIG8_PLAN_ARGS)


# What the JAX package's run_sweep of config8_plan(range(8)) reports for
# each lane, "<canonical spec>@<seed>": (run_digest of the lane's state
# — its leaves flattened by jax.tree_util.keystr, leading dot dropped,
# the knob leaf included — and its metric series, rounds run, converged
# round, the invariant violations as (round, invariant), and the
# resilience block's RESILIENCE_INTS). Made on the CPU with
#   build_plan(base, CONFIG8_SCENARIOS, range(8), rounds=96,
#              write_rounds=16)
#   run_sweep(plan, max_rounds=1024, chunk=16)
# (base the SimConfig of config8_lane_config(256)); CONFIG8_FRONTIERS
# holds, by seed count, the sha256 of json.dumps(build_frontier(
# res.lanes), sort_keys=True) of that run and of the same run over
# range(4), range(2) and range(1) (whose lanes equal the first seeds'
# here). A lane of a compacted or pipelined run reports the same.
SWEEP_PINS = {
    "lossy:p=0.1@0": (
        "abb41c681c6dcb9bfda34bc321f47a3bd61424b6603fb229d92966850fa4d094",
        64, 60, [], (None, None, 0, 0, 0, 0, 0, 0, 4)),
    "lossy:p=0.1@1": (
        "b471d104a64b7d57ebd88cb56ab3e36ce00e9b6ed8508560ca95a001d63261fb",
        64, 60, [], (None, None, 0, 0, 0, 0, 0, 0, 4)),
    "lossy:p=0.1@2": (
        "2d7c6e1c0f0128ca1cf5d48dbb3f01389e0ba0ab5ac467620f0536cbf3387952",
        64, 64, [], (None, None, 0, 0, 0, 0, 0, 0, 4)),
    "lossy:p=0.1@3": (
        "112c9ad28b02285afa48177152c1ee2a42f47ae6d190ed92b6a7b56e92c8c728",
        64, 60, [], (None, None, 0, 0, 0, 0, 0, 0, 4)),
    "lossy:p=0.1@4": (
        "19c9b5ecec1b0109ed012e7eb9abbf3a50377db0419453e779dbeb41446cc4d4",
        64, 64, [], (None, None, 0, 0, 0, 0, 0, 0, 4)),
    "lossy:p=0.1@5": (
        "7119e1e2777e08c7db42c80e40d9186e90493bbfd2f92152d7563d6cd61cd192",
        64, 60, [], (None, None, 0, 0, 0, 0, 0, 0, 4)),
    "lossy:p=0.1@6": (
        "afdf2444503f87f175729b9217dc915e3de08de598006201b0f62b78f24305a8",
        64, 60, [], (None, None, 0, 0, 0, 0, 0, 0, 4)),
    "lossy:p=0.1@7": (
        "9289add9a49b8e99fcf78e7e47452c92d3ebc5cd914889dcb02bdb84439be642",
        64, 60, [], (None, None, 0, 0, 0, 0, 0, 0, 4)),
    "churn:down=6,rate=0.05,until=48@0": (
        "207ba8afc8586c4c7afcdb8b30287be52ec63dcf7d8850db1384f98f9ab09417",
        80, 72, [], (53, 19, 0, 0, 0, 0, 19115, 285, 5)),
    "churn:down=6,rate=0.05,until=48@1": (
        "159cbdb85ee9cbf3f203af47a49fcb45d7f644a99f5973912a6371fd1e77f7e3",
        80, 72, [], (53, 19, 0, 0, 0, 0, 18343, 821, 5)),
    "churn:down=6,rate=0.05,until=48@2": (
        "be343a5a55a4f2b7982307a3186172798da612b24d183d5f441b71d9cee47777",
        80, 72, [], (53, 19, 0, 0, 0, 0, 18495, 390, 5)),
    "churn:down=6,rate=0.05,until=48@3": (
        "7289aa7b549df40fc15b044460cfaaf08e411b16e59b229a1cc3bb8a90940eaa",
        80, 68, [], (53, 15, 0, 0, 0, 0, 17150, 563, 5)),
    "churn:down=6,rate=0.05,until=48@4": (
        "67caca207241dd479795b72e211663d0d363a6d2b41ae0459c80d47644edb76e",
        80, 68, [], (53, 15, 0, 0, 0, 0, 17314, 791, 5)),
    "churn:down=6,rate=0.05,until=48@5": (
        "a79878843ccefb52f27197634b6a44bf327cbabaf1bf3ba01f26e7e82e56591e",
        80, 76, [], (53, 23, 0, 0, 0, 0, 20892, 936, 5)),
    "churn:down=6,rate=0.05,until=48@6": (
        "a90c4a45d6750545445b975f12464daa6904ab0f3ebc31b44ae3ce5bbfa440b4",
        80, 68, [], (53, 15, 0, 0, 0, 0, 17773, 458, 5)),
    "churn:down=6,rate=0.05,until=48@7": (
        "20dd7ef68675f7713c9b828b8bb9de6823f58c7906d76861aed71e084da4da52",
        80, 68, [], (53, 15, 0, 0, 0, 0, 18492, 414, 5)),
    "crash_amnesia:at=8,down=4,jump=0,nodes=3@0": (
        "6ccf29a2321ab697d3d60e5cb312d09d0e1f6ff9ffe9c4cec9be181d628e99f3",
        64, 56, [], (12, 44, 0, 3702, 3, 3, 13, 0, 4)),
    "crash_amnesia:at=8,down=4,jump=0,nodes=3@1": (
        "d8063849e1643b95c0a8246ac536befda5376c7e31934a9938f7e956c5e36134",
        64, 56, [], (12, 44, 0, 3786, 3, 3, 36, 0, 4)),
    "crash_amnesia:at=8,down=4,jump=0,nodes=3@2": (
        "24618da332da41ca435c5d3e812fb2a8f5714481d8a8d0a03b286e8bdc349008",
        64, 52, [], (12, 40, 0, 3750, 3, 3, 28, 0, 4)),
    "crash_amnesia:at=8,down=4,jump=0,nodes=3@3": (
        "399c3e33be051b3c5fac7620f54a2fc5343be889804c9d5736d075ed1fc94c25",
        64, 56, [], (12, 44, 0, 3735, 3, 3, 21, 0, 4)),
    "crash_amnesia:at=8,down=4,jump=0,nodes=3@4": (
        "41111e9b40627bbaecaac3ff81e3c0f2547469d21c5d467b984392f3f034ff23",
        64, 56, [], (12, 44, 0, 3645, 3, 3, 20, 0, 4)),
    "crash_amnesia:at=8,down=4,jump=0,nodes=3@5": (
        "0b2f5336c0759db227ca82090bb2fd9fc1d28426b906ab60451cf2760e1f7227",
        64, 60, [], (12, 48, 0, 3726, 3, 3, 22, 0, 4)),
    "crash_amnesia:at=8,down=4,jump=0,nodes=3@6": (
        "145b39a2e3a3a16636867095ffaea4ab17c0ad031f25dd394d2d8b66f894faed",
        64, 52, [], (12, 40, 0, 3693, 3, 3, 14, 0, 4)),
    "crash_amnesia:at=8,down=4,jump=0,nodes=3@7": (
        "9449ba4ae9ca28fe028b8ba5dab823e14a24e4e9a46cb71b76f65fdbc85bacc2",
        64, 52, [], (12, 40, 0, 3609, 3, 3, 21, 0, 4)),
    "clock_skew:max_skew=64,nodes=64@0": (
        "d66796f4bb2eed1aa520dbd514bd3277bb8e5dd0dbfddfe4751e1f9a3bb16922",
        64, 56, [], (15, 41, 0, 0, 0, 0, 0, 0, 4)),
    "clock_skew:max_skew=64,nodes=64@1": (
        "b20800330b99abc8124746e6beb2d2b197d5606a49c5d256d2c73a025c8665c0",
        64, 56, [], (15, 41, 0, 0, 0, 0, 0, 0, 4)),
    "clock_skew:max_skew=64,nodes=64@2": (
        "ac997396bff893df790fcea76d6d74f1bd350ce103b59b6b6cf782f5f077979a",
        64, 56, [], (15, 41, 0, 0, 0, 0, 0, 0, 4)),
    "clock_skew:max_skew=64,nodes=64@3": (
        "833029d30588eaaa1d54bd1886b97cebe5862e22afe4d436082646492d979403",
        64, 56, [], (15, 41, 0, 0, 0, 0, 0, 0, 4)),
    "clock_skew:max_skew=64,nodes=64@4": (
        "1d2cea9feac5ca1b7f36f32377a125e2600c7b62668cfa6419a904125ce2d71a",
        64, 52, [], (15, 37, 0, 0, 0, 0, 0, 0, 4)),
    "clock_skew:max_skew=64,nodes=64@5": (
        "ce317ac3d638117b4bff00d186f5ebd8d135ca5376d8920eb4529a25d96ef9d8",
        64, 56, [], (15, 41, 0, 0, 0, 0, 0, 0, 4)),
    "clock_skew:max_skew=64,nodes=64@6": (
        "682dae267f7f90b64903ea35edd52dd24f6b3b70df91fb56656d9420268c88d4",
        64, 52, [], (15, 37, 0, 0, 0, 0, 0, 0, 4)),
    "clock_skew:max_skew=64,nodes=64@7": (
        "81bbb0cee937e8c9b74bf139ff481c8fc5f055899b6a6e454cc92c58c139c376",
        64, 56, [], (15, 41, 0, 0, 0, 0, 0, 0, 4)),
}
CONFIG8_FRONTIERS = {
    8: "50881eaf133f93cb90f96652ac544773a0bd1e6f4799b66274d49c2d7a07e55f",
    4: "b3a8a91b2fe62fd612af7314db5a15da1a9ee5372b7192d5e5964c195506856a",
    2: "a0e9ff1309dd8434524a7af3030b9c1e86f7f92526743795cf684bae2dc611ed",
    1: "3ad5e0dfb01ba54e529af60b2be6a81f2f493c8456178ab2f3c8892de5ea5a10",
}


# The invariant verdicts of config 8's lanes at 1024 nodes (seed 0, by
# scenario): the JAX package's serial run of each on the CPU
# (make_scenario(spec, 1024, rounds=96, write_rounds=16, seed=0), its
# config on config8_lane_config(1024), an InvariantChecker and a
# ResilienceScorecard, run_sim(max_rounds=1024, chunk=16, seed=0,
# min_rounds=max(heal_round, 16))). Under churn the reference's own
# checker reports a SWIM false-DOWN every chunk from round 31 (observer
# 0 holding a live node DOWN past the window; ROADMAP.md queue 3): that
# run converges at round 148 of 160 with no row lost and 87 354
# false-DOWN beliefs counted, and the port's lane must report the same.
CONFIG8_1024_VIOLATIONS = {
    "lossy": [], "crash_amnesia": [], "clock_skew": [],
    "churn": [(r, "swim_false_down")
              for r in (31, 47, 63, 79, 95, 111, 127, 143, 159)],
}
CONFIG8_1024_CHURN = {"rounds": 160, "converged_round": 148,
                      "swim_false_down": 87354}


# Config 0's churn soak (SWIM_CHURN_SPEC with SOAK_ARGS, seed 0) at 1024,
# 2048 and 4096 nodes: what the JAX package's serial soak loop reports on
# the CPU (tests/test_torch_cli.py::jax_swim_churn_pins holds the recipe)
# as (rounds run, converged round, the invariant violations as (round,
# invariant, detail), run_digest of the final state and metrics). 4096
# is the smallest of the three sizes with a swim_false_down verdict, in
# both packages; chip_smoke.py's "swim_churn_4096" holds the card to it.
SWIM_CHURN_SPEC = "churn:rate=0.05"
SWIM_CHURN_PINS = {
    1024: (80, 70, [], "51876ddacc81ddb58b3d4e74e108f3bf"
                       "d122d02f113e8c49436c292a25f2e763"),
    2048: (80, 70, [], "989c017147f60fe79310800bca952913"
                       "582d7001a8c96797f6678f57727bf657"),
    4096: (80, 70, [(79, "swim_false_down",
                     "observer 81 believes live node 3334 DOWN after 73 "
                     "rounds of mutual reachability (window 72)")],
           "3aad8fe3963847ed36d2b8a2393718c4"
           "ce867d79f2a9fd5e052fdb7ead001c9f"),
}


# "config8_compact": the lossy and crash-amnesia lanes of seed 0 as a
# plan of their own (CONFIG8_COMPACT_SCENARIOS). Its union config arms
# fewer sweep dimensions than the four-scenario plan, so the lanes' knob
# leaf, and with it their digests, differ from SWEEP_PINS; their rounds,
# verdicts and resilience blocks do not. Made on the CPU with
#   build_plan(base, CONFIG8_COMPACT_SCENARIOS, [0], rounds=96,
#              write_rounds=16)
#   run_sweep(plan, max_rounds=1024, chunk=16)
# recorded as SWEEP_PINS are (about 20 s).
CONFIG8_COMPACT_SCENARIOS = CONFIG8_SCENARIOS[0::2]
CONFIG8_COMPACT_PINS = {
    "lossy:p=0.1@0": (
        "1f5c36ecb8c821118ca5fa8ad330fc871e51b8687d7a4a52d4ab1da8c30292f4",
        64, 60, [], (None, None, 0, 0, 0, 0, 0, 0, 4)),
    "crash_amnesia:at=8,down=4,jump=0,nodes=3@0": (
        "7a0bc765a54edac194e42d982f946d89cdc5ab9efeeaae8d0258934fbfedb5bb",
        64, 56, [], (12, 44, 0, 3702, 3, 3, 13, 0, 4)),
}


def sweep_lane_record(lr, pins: dict = SWEEP_PINS) -> dict:
    """A sweep lane's outcome beside its pin (``SWEEP_PINS``, or the
    ``pins`` of another plan)."""
    key = f"{lr.spec}@{lr.seed}"
    want = pins[key]
    viol = [(v["round"], v["invariant"])
            for v in (lr.invariants or {}).get("violations", [])]
    got_res = (None if lr.resilience is None else
               tuple(lr.resilience[k] for k in RESILIENCE_INTS))
    digest = run_digest(state_to_numpy(lr.state), lr.metrics)
    rec = {"lane": key, "rounds": lr.rounds,
           "converged_round": lr.converged_round, "digest": digest,
           "violations": viol, "resilience": got_res,
           "invariants_ok": (lr.invariants or {}).get("ok")}
    rec["match"] = (digest == want[0] and lr.rounds == want[1]
                    and lr.converged_round == want[2]
                    and viol == [tuple(v) for v in want[3]]
                    and got_res == (None if want[4] is None
                                    else tuple(want[4])))
    return rec


def frontier_digest(frontier: dict) -> str:
    return hashlib.sha256(
        json.dumps(frontier, sort_keys=True).encode()).hexdigest()


def sync_mailbox_lanes(cfg: SimConfig) -> int:
    """The lanes per node of the sync sweep's merge mailbox under
    ``cfg`` (``sync/sync.py``: K' actors × ``sync_cap_per_actor`` × S
    cells, padded to 128), the cap the kernel is launched with."""
    a = cfg.num_actors
    kp = min(cfg.sync_actor_topk, a)
    req = cfg.sync_req_actors or 2 * kp
    lanes = (min(req, kp * cfg.resolved_sync_peers, a)
             * cfg.sync_cap_per_actor * cfg.seqs_per_version)
    return lanes + (-lanes) % 128


def twin_match(lane_result, serial: RunResult) -> dict:
    """A sweep lane against its serial twin run on the same device:
    whether the rounds, the converged round, every metric the twin
    computes and every state leaf the twin holds are equal (the lane
    adds its knob leaf and the union config's zero-valued metric
    families)."""
    got = state_to_numpy(lane_result.state)
    want = state_to_numpy(serial.state)
    leaves = all(np.array_equal(got[k], v) for k, v in want.items())
    metrics = all(np.array_equal(np.asarray(lane_result.metrics[k]),
                                 np.asarray(v))
                  for k, v in serial.metrics.items())
    return {"rounds": lane_result.rounds == serial.rounds,
            "converged_round": (lane_result.converged_round
                                == serial.converged_round),
            "metrics": metrics, "leaves": leaves,
            "match": (leaves and metrics
                      and lane_result.rounds == serial.rounds
                      and lane_result.converged_round
                      == serial.converged_round)}


# ------------------------------------------------- the JAX sim token
# A resume token the JAX package wrote (tests/fixtures/
# sim_token_jax_64.npz): config 8's lane base at 64 nodes soaked under
# crash_amnesia (seed 0, config 8's soak arguments, no checker), checkpointed
# after every chunk and killed from on_chunk after chunk 1, so the token
# holds chunk 0's end. tests/test_torch_checkpoint.py regenerates it with
# the JAX package; its resume must reach DIGESTS["token_jax_64"], the JAX
# package's uninterrupted run, at TOKEN_ROUNDS (rounds, converged round).
TOKEN_FIXTURE = os.path.join("tests", "fixtures", "sim_token_jax_64.npz")
TOKEN_SPEC = "crash_amnesia"
TOKEN_NODES = 64
TOKEN_KILL_AFTER = 1
TOKEN_ROUNDS = (32, 24)


def token_case(device=None) -> tuple:
    """``(cfg, schedule, run_kw)`` of the token's run, for ``run_sim``."""
    args = CONFIG8_SOAK_ARGS
    sc = make_scenario(TOKEN_SPEC, TOKEN_NODES, rounds=args["rounds"],
                       write_rounds=args["write_rounds"], seed=0)
    cfg = sc.apply(config8_lane_config(TOKEN_NODES))
    run_kw = dict(max_rounds=args["max_rounds"], chunk=args["chunk"],
                  seed=0, min_rounds=max(sc.heal_round or 0,
                                         args["write_rounds"]))
    if device is not None:
        run_kw["device"] = device
    return cfg, sc.schedule(), run_kw


# ------------------------------------------------------ the digital twin
# Consul's two tables (corro_sim_torch.schema.consul_schema_sql()) with
# their six value columns each, in declaration order, and the pk prefix
# of each table's ids.
TWIN_TABLES = (
    ("consul_services", "svc",
     ("name", "tags", "meta", "port", "address", "updated_at")),
    ("consul_checks", "chk",
     ("service_id", "service_name", "name", "status", "output",
      "updated_at")),
)
_TAGS = ('[]', '["prod"]', '["prod","edge"]', '["canary"]')
_STATUS = ("passing", "warning", "critical")


def _twin_value(table: str, col: int, rng, ts: int):
    """A Consul-shaped value for column ``col`` of ``table``."""
    if col == 5:
        return ts  # updated_at
    if table == "consul_services":
        return (f"svc-{rng.integers(32)}",
                _TAGS[rng.integers(len(_TAGS))],
                f'{{"app_id": {rng.integers(64)}}}',
                int(rng.integers(8000, 8064)),
                f"10.{rng.integers(4)}.{rng.integers(16)}."
                f"{rng.integers(256)}")[col]
    return (f"svc-{rng.integers(256)}", f"svc-{rng.integers(32)}",
            f"check-{rng.integers(16)}", _STATUS[rng.integers(3)],
            f"HTTP GET: {(200, 500, 503)[rng.integers(3)]}")[col]


@dataclasses.dataclass
class TwinFeed:
    """A synthetic changeset feed (:func:`twin_feed`) and what it
    holds."""

    lines: list  # ND-JSON lines, each ending in a newline
    malformed: list  # indexes of the malformed lines
    copies: list  # (index, index of the line it repeats) pairs
    empties: int  # EmptySet lines (overwritten versions cleared)
    deletes: int  # changesets that delete a row (__crsql_del)
    rows: int  # primary keys written, both tables

    def expected_bad(self, chunk_lines: int) -> dict:
        """The quarantine tallies of a shadow that consumes the feed in
        chunks of ``chunk_lines``: each malformed line; a copy in its
        original's chunk is a duplicate, in a later chunk a stale
        version."""
        dup = sum(i // chunk_lines == j // chunk_lines
                  for i, j in self.copies)
        out = {"malformed": len(self.malformed), "duplicate": dup,
               "stale_version": len(self.copies) - dup}
        return {k: v for k, v in out.items() if v}


def twin_feed(seed: int, actors: int, versions: int, keys: int = 256,
              zipf: float = 1.1, hostile: float = 0.005,
              clear_rate: float = 0.05, delete_rate: float = 0.02,
              conflict_rate: float = 0.1) -> TwinFeed:
    """A seeded Consul-schema changeset feed in the JAX package's trace
    format (:func:`corro_sim_torch.io.traces.dump_changeset`; numpy and
    the standard library only, so the JAX package reads the same text).

    ``actors`` writers emit ``versions`` changesets each, interleaved by
    version (every actor's version ``v`` in a seeded order, then
    ``v + 1``). Both Consul tables hold ``keys`` primary keys; every row
    is first inserted in full by one actor (two changesets of three
    cells), then updated: rows chosen Zipf(``zipf``) over a seeded
    order (the skew of config 3), 1-4 cells per changeset. Col versions
    climb per cell; a ``conflict_rate`` share of writes reuse the cell's
    current col version (a concurrent write from the same base, settled
    by the value order), so actors conflict. A ``delete_rate`` share of
    updates delete their row (``__crsql_del``, the causal length made
    even; the next write resurrects it). A ``clear_rate`` share of
    updates overwrite the actor's previous update cell for cell and
    are followed by an EmptySet of the overwritten version (it lands in
    the same chunk or later, a late clear). Then a ``hostile`` share of
    lines is added, in thirds: malformed (a truncated line), duplicates
    (a Full changeset repeated right after itself) and stale versions
    (one repeated 4096 lines later, or last)."""
    from corro_sim_torch.io.traces import dump_changeset

    rng = np.random.default_rng(seed)
    ids = [f"{a:08x}-7417-4000-8000-{seed:012x}" for a in range(actors)]
    rows = [(table, (f"node-{k % 32}", f"{prefix}-{k}"), table)
            for table, prefix, _ in TWIN_TABLES for k in range(keys)]
    cols = {table: names for table, _, names in TWIN_TABLES}
    n_rows = len(rows)
    weights = np.empty(n_rows)
    weights[rng.permutation(n_rows)] = (
        1.0 / np.arange(1, n_rows + 1) ** zipf)
    weights /= weights.sum()
    cv = np.zeros((n_rows, 6), np.int64)
    cl = np.zeros(n_rows, np.int64)
    inserts: dict = {a: [] for a in range(actors)}
    for r in range(n_rows):
        inserts[r % actors] += [(r, (0, 1, 2)), (r, (3, 4, 5))]
    if max(len(v) for v in inserts.values()) > versions:
        raise ValueError(f"{versions} versions cannot hold the inserts of "
                         f"{n_rows} rows by {actors} actors")
    base: list = []  # (line, (actor, version) or None)
    last_update: dict = {}  # actor -> (version, row, cols)
    cleared: set = set()
    deletes = empties = 0

    def cell(r, j, ts, concurrent=True):
        table, pk, _ = rows[r]
        c = int(cv[r, j])
        new = (c if concurrent and c > 0 and rng.random() < conflict_rate
               else c + 1)
        cv[r, j] = max(c, new)
        return (table, pk, cols[table][j], _twin_value(table, j, rng, ts),
                new, int(cl[r]))

    for v in range(1, versions + 1):
        for a in (int(x) for x in rng.permutation(actors)):
            ts = 1000 + len(base)
            over = None
            if inserts[a]:
                r, js = inserts[a].pop(0)
                cl[r] += 1 - cl[r] % 2  # live (resurrected if deleted)
                cells = [cell(r, j, ts) for j in js]
            elif a in last_update and rng.random() < clear_rate:
                over, r, js = last_update.pop(a)
                cl[r] += 1 - cl[r] % 2
                cells = [cell(r, j, ts, concurrent=False) for j in js]
                last_update[a] = (v, r, js)
            else:
                r = int(rng.choice(n_rows, p=weights))
                if cl[r] % 2 == 1 and rng.random() < delete_rate:
                    cl[r] += 1
                    table, pk, _ = rows[r]
                    cells = [(table, pk, "__crsql_del", None, 1,
                              int(cl[r]))]
                    deletes += 1
                    last_update.pop(a, None)
                else:
                    cl[r] += 1 - cl[r] % 2
                    js = tuple(sorted(rng.choice(
                        6, int(rng.integers(1, 5)), replace=False)))
                    cells = [cell(r, int(j), ts) for j in js]
                    last_update[a] = (v, r, js)
            base.append((dump_changeset(ids[a], v, ts, cells) + "\n",
                         (a, v)))
            if over is not None:
                cleared.add((a, over))
                empties += 1
                base.append((json.dumps({
                    "actor_id": ids[a], "versions": [over, over],
                    "ts": 1000 + len(base)}) + "\n", None))
    # the hostile lines, placed after chosen base lines
    n_bad = int(round(hostile * len(base)))
    full = [i for i, (_, key) in enumerate(base)
            if key is not None and key not in cleared]
    picks = rng.choice(len(full), size=n_bad, replace=False)
    after: dict = {}  # base index -> [(line, kind, original index)]
    for k, p in enumerate(picks):
        i = full[int(p)]
        line = base[i][0]
        if k % 3 == 0:
            after.setdefault(i, []).append(
                (line[:len(line) // 2] + "\n", "malformed", None))
        elif k % 3 == 1:
            after.setdefault(i, []).append((line, "copy", i))
        else:
            at = min(i + 4096, len(base) - 1)
            after.setdefault(at, []).append((line, "copy", i))
    lines, malformed, copies, where = [], [], [], {}
    for i, (line, _) in enumerate(base):
        where[i] = len(lines)
        lines.append(line)
        for bad, kind, orig in after.get(i, ()):
            if kind == "malformed":
                malformed.append(len(lines))
            else:
                copies.append((len(lines), where[orig]))
            lines.append(bad)
    return TwinFeed(lines=lines, malformed=malformed, copies=copies,
                    empties=empties, deletes=deletes, rows=n_rows)


def twin_config(universe, heads, n: int, chunk_lines: int,
                skip_bad: bool = True, drain_rounds: int = 4096,
                **overrides) -> SimConfig:
    """The shadow's configuration for a feed: its universe's shape (the
    log ring sized by the feed's final horizons ``heads``,
    ``probe_feed_heads``) at ``n`` nodes, with config 3's protocol knobs
    (full-view SWIM, a sync sweep every 8 rounds, 16 actors per
    peer)."""
    from corro_sim_torch.config import TwinConfig

    cfg = universe.suggest_config(
        rounds=int(heads.max(initial=0)) + 1, num_nodes=n,
        swim_enabled=True, sync_interval=8, sync_actor_topk=16,
        **overrides)
    return dataclasses.replace(cfg, twin=TwinConfig(
        enabled=True, chunk_lines=chunk_lines, skip_bad=skip_bad,
        drain_rounds=drain_rounds)).validate()


def feed_config(lines, n: int, chunk_lines: int, **kw) -> SimConfig:
    """:func:`twin_config` of a whole feed, scanned whole."""
    from corro_sim_torch.engine.twin import probe_feed_heads, twin_universe

    uni = twin_universe(lines, 0)
    return twin_config(uni, probe_feed_heads(lines, uni), n, chunk_lines,
                       **kw)


# chip_smoke.py's twin phases. "twin_digests": a feed of 64 actors ×
# 16 versions over 32 keys of each Consul table (64 rows × 6 columns: a
# cell space the merge kernel takes) shadowed at 256 nodes in chunks of
# 256 lines, a cursor token every chunk, then the forecast grid of the
# JAX package's tests/test_twin.py from the fork. "twin_10k": a feed of
# 128 actors × 24 versions over 256 keys of each table (512 rows × 6
# columns) shadowed at 10 000 nodes in chunks of 2048 lines, quarantine
# on, then the same grid at 10 000 nodes. 128 actors, not 1024: the
# JAX package's pinned table comes from its shadow at 256 nodes (a
# shadow holds at most one actor per node), and a wiped node re-syncs
# every actor's history at 16 actors a sweep, so the forecast's crash
# lanes take rounds in proportion to the actors (224-232 rounds at 10k
# with 256 actors), beyond chip_smoke.py's time budget.
TWIN_DIGEST_FEED = dict(seed=0, actors=64, versions=16, keys=32)
TWIN_DIGEST_NODES, TWIN_DIGEST_CHUNK = 256, 256
TWIN_10K_FEED = dict(seed=0, actors=128, versions=24, keys=256)
TWIN_10K_CHUNK = 2048
TWIN_PIN_NODES = 256  # where the JAX package ran the 10k feed
TWIN_FORECAST = dict(scenarios=["lossy:p=0.3",
                                "crash_amnesia:nodes=2,at=4,down=4"],
                     seeds=[0, 1], rounds=32, max_rounds=256, chunk=8)
# the same grid at 10 000 nodes cut to seed 0's lossy lane (the other
# seed and the crash lane are left out for chip_smoke.py's time budget),
# in chunks of 16 rounds: the checkers read each lane's (N, N) heads and
# SWIM statuses once a chunk, so at 10k their host seconds follow the
# chunk count
TWIN_10K_FORECAST = dict(TWIN_FORECAST, scenarios=TWIN_FORECAST[
    "scenarios"][:1], seeds=[0], max_rounds=512, chunk=16)
TWIN_THRESHOLDS = {"twin_forecast": {
    "default": {"require_converged": True, "rows_lost_max": 0},
    "scenarios": {"crash_amnesia": {"recovery_rounds_worst_max": 48}},
}}


# What the JAX package's runs on the CPU of chip_smoke.py's twin phases
# report (tests/test_torch_twin.py::jax_twin_pins holds the recipe,
# about 90 s): "twin_digests" the shadow's twin_shadow_record and the
# forecast's twin_forecast_record; "twin_10k" node 0's decoded table
# after the 10k feed is shadowed at TWIN_PIN_NODES nodes (a converged
# table depends on the feed, not on the node count), its live rows, the
# quarantine tallies and the rounds that shadow took there.
TWIN_PINS = {
    "twin_digests": {
        "shadow": {
            "digest": "47be9bae8faf9f7c4fa9bf1681fa410d4287dd88d33d61dc7602662263919dbf",
            "headlines": "a3e0920c613587e42364a555bfc5a9b8213a321eec27c7040e19bb6d2f816e2c",
            "report": "5663e17d618d5ee4017d43fab6f76d2dc01cc9bc0129f2030b2a9032f8be0842",
            "rounds": 120,
            "converged_round": 120,
        },
        "frontier": "32fc994726626b3d6aa47267eb68275ac3cd9f74ce2f9b87545db3fe9d6a00b9",
        "trend": "d0a571ec50a629875e6f8422a0bf22e2732ff6eaf204d3ab6346c8db710b22ec",
        "lanes": {
            "lossy:p=0.3@0":
                "dcfbebbe6314a111fc4e19f59e2a369ae7f13db83fc44ced1cf052e2d86cc6b6",
            "lossy:p=0.3@1":
                "02b26f5d85cf11ecb1d544b729b7358925428f74192ec8a997bc89cda5b58ba3",
            "crash_amnesia:at=4,down=4,jump=0,nodes=2@0":
                "9a83bffee841619a8ab4489e32ec4533d0f2884a023e84180bb4623145430922",
            "crash_amnesia:at=4,down=4,jump=0,nodes=2@1":
                "44220d57a9635305abe961648ef9df76d8eb67aad74b8a8671fcd38a3a719498",
        },
    },
    "twin_10k": {
        "table": "3084a79c9b461d3fb6b8ef5c504bffe258312a3659038f047b80ef1739bcad6c",
        "live_rows": 507,
        "bad_by_reason": {"duplicate": 6, "malformed": 6, "stale_version": 4},
        "rounds_at_256": 328,
    },
}


# What the JAX package's run on the CPU of chip_smoke.py's "subs_digests"
# population reports (tests/test_torch_subs.py::jax_subs_pins holds the
# recipe): subs_record's digests and counts, the cut replay's rounds and
# the converged round, at SUBS_PIN_NODES nodes.
SUBS_PINS = {"subs_digests": {
    "initial":
        "9195b6d64b8f137e79920c3d57e08b573f0da8cab49eb26dc19358ec8acf594d",
    "step":
        "c55f1d563e9bc5fb192842296f222cb23513d9e17c8dc9d2c73ae123e41b7d69",
    "matchers": 64,
    "initial_rows": 600,
    "step_events": 3835,
    "cut_rounds": 8,
    "converged_round": 216,
}}


def _json_digest(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()


def twin_shadow_record(leaves: dict, result) -> dict:
    """A shadow's outcome as its pin holds it: the run digest of its
    state ``leaves`` (flattened as ``run_digest`` reads them) and metric
    series, the digests of its headlines and of its report (the feed's
    name left out), its rounds and converged round."""
    return {
        "digest": run_digest(leaves, result.metrics),
        "headlines": _json_digest(result.headlines),
        "report": _json_digest({k: v for k, v in result.report.items()
                                if k != "feed"}),
        "rounds": result.rounds,
        "converged_round": result.converged_round,
    }


def twin_forecast_record(block: dict, fork_path: str, lanes) -> dict:
    """A forecast's outcome as its pin holds it: the digests of its
    frontier and trend (the fork's path made neutral) and each lane's
    ``run_digest``, from ``lanes``: ``(spec, seed, leaves, metrics)``."""
    def neutral(obj):
        return json.loads(json.dumps(obj, sort_keys=True, default=str)
                          .replace(fork_path, "<fork>"))

    return {
        "frontier": _json_digest(neutral(block["frontier"])),
        "trend": _json_digest(neutral(block["trend"])),
        "lanes": {f"{spec}@{seed}": run_digest(leaves, metrics)
                  for spec, seed, leaves, metrics in lanes},
    }


def table_digest(table: dict) -> str:
    """sha256 of a decoded table (``read_table``'s ``{(table, pk):
    {cid: value}}``) in sorted order."""
    items = sorted((repr(k), sorted(v.items())) for k, v in table.items())
    return hashlib.sha256(repr(items).encode()).hexdigest()


def universe_view(universe):
    """What ``read_table`` reads of a trace, from a twin's universe."""
    import types

    return types.SimpleNamespace(row_keys=universe.row_keys,
                                 col_keys=universe.col_triples(),
                                 values=universe.values)


# ---------------------------------------------- the subscription engine
# chip_smoke.py's subscription phases. The table is "twin_10k"'s Consul
# feed (TWIN_10K_FEED: both tables at 256 keys, 512 rows × 6 columns,
# 128 actors) with its hostile lines dropped, ingested against the
# Consul schema and replayed twice: cut after SUBS_CUT_ROUNDS rounds
# (a third of the versions injected, so observers disagree) and to
# convergence. SUBS_SQLS distinct queries, each on SUBS_OBSERVERS
# seeded observer nodes, make config 6's live-half population of 64
# matchers (corro_sim/benchmarks.py:794-795); SUBS_PER_MATCHER
# subscribers each (1024 in all) register them through get_or_insert's
# dedupe, in a seeded order, under SQL spellings that normalize alike.
SUBS_FEED = TWIN_10K_FEED
SUBS_CUT_ROUNDS = 8
SUBS_SEED = 0
SUBS_OBSERVERS = 2
SUBS_PER_MATCHER = 16
SUBS_PIN_NODES = 256  # where the JAX package ran the population
SUBS_MAX_ROUNDS = 1024


def subs_lines(feed: TwinFeed) -> list:
    """The feed's lines without its hostile ones, as ``validate_feed``
    finds them under the twin's chunking (the replay ingests in one
    batch, which refuses a malformed line)."""
    from corro_sim_torch.engine.twin import twin_universe
    from corro_sim_torch.io.traces import validate_feed

    bad = validate_feed(feed.lines, twin_universe(feed.lines, 0),
                        chunk_lines=TWIN_10K_CHUNK)
    drop = {no - 1 for no, _, _ in bad}  # line numbers count from 1
    return [ln for i, ln in enumerate(feed.lines) if i not in drop]


def subs_capacities(keys: int) -> dict:
    """Row capacities of the Consul layout: ``keys`` rows per table."""
    return {"consul_services": keys, "consul_checks": keys}


def subs_queries(seed: int, nodes: int, keys: int) -> list:
    """``(sql, observer)`` of each distinct matcher: what a Consul-sync
    consumer runs against ``consul_services`` and ``consul_checks``
    (profile_slice.TWIN_TABLES' values): numeric ranges on ``port``,
    ``status =`` and ``IN``, a ``LIKE`` prefix on ``name``, a pk term on
    ``node``, ``corro_json_contains`` on ``tags`` (split to the host),
    ``IS NULL`` and ``NOT``, two aggregates, a join and an
    ``IN (SELECT …)``; constants seeded, each query on
    ``SUBS_OBSERVERS`` distinct seeded observers in ``[0, nodes)``."""
    rng = np.random.default_rng(seed)
    sqls = []
    for lo in rng.choice(56, 10, replace=False):
        hi = 8000 + int(lo) + int(rng.integers(2, 9))
        sqls.append("SELECT name, port FROM consul_services WHERE "
                    f"port >= {8000 + int(lo)} AND port < {hi}")
    for k in rng.choice(9, 4, replace=False):
        sqls.append("SELECT name, status, output FROM consul_checks WHERE "
                    f"status = '{_STATUS[int(k) % 3]}' AND "
                    f"output = 'HTTP GET: {(200, 500, 503)[int(k) // 3]}'")
    for k in rng.choice(32, 3, replace=False):
        a, b = rng.choice(3, 2, replace=False)
        sqls.append("SELECT id, status FROM consul_checks WHERE status IN "
                    f"('{_STATUS[int(a)]}', '{_STATUS[int(b)]}') AND "
                    f"service_name >= 'svc-{int(k)}'")
    for d in rng.choice(np.arange(1, 10), 4, replace=False):
        sqls.append("SELECT name, address FROM consul_services WHERE "
                    f"name LIKE 'svc-{int(d)}%'")
    for k in rng.choice(min(keys, 32), 3, replace=False):
        sqls.append("SELECT port, address FROM consul_services WHERE "
                    f"node = 'node-{int(k)}' AND "
                    f"port >= {8000 + int(rng.integers(32))}")
    for tags in ('["prod"]', '["canary"]'):
        sqls.append("SELECT name, tags FROM consul_services WHERE "
                    f"corro_json_contains('{tags}', tags) AND "
                    f"port < {8032 + int(rng.integers(32))}")
    sqls.append("SELECT name, output FROM consul_checks WHERE "
                "output IS NOT NULL AND NOT (status = 'passing')")
    sqls.append("SELECT id, port FROM consul_services WHERE "
                f"address IS NULL OR NOT (port < {8000 + int(rng.integers(64))})")
    sqls.append("SELECT status, COUNT(*) FROM consul_checks GROUP BY status")
    sqls.append("SELECT name, COUNT(*), MAX(port) FROM consul_services "
                "GROUP BY name")
    sqls.append("SELECT s.id, s.port, c.id, c.status FROM consul_services s "
                "JOIN consul_checks c ON s.name = c.service_name "
                "WHERE c.status = 'critical'")
    sqls.append("SELECT id, status FROM consul_checks WHERE service_name IN "
                "(SELECT name FROM consul_services WHERE "
                f"port < {8008 + int(rng.integers(16))})")
    return [(sql, int(node)) for sql in sqls
            for node in rng.choice(nodes, SUBS_OBSERVERS, replace=False)]


def _spelling(sql: str, k: int) -> str:
    """Spelling ``k`` (of 16) of ``sql``: keywords lower-cased by the
    bits of ``k``; every spelling normalizes to the same query."""
    for bit, word in enumerate((" FROM ", " WHERE ", " AND ", " JOIN ")):
        if k >> bit & 1:
            sql = sql.replace(word, word.lower())
    return sql


def subs_subscribers(queries: list, seed: int,
                     per: int = SUBS_PER_MATCHER) -> list:
    """``(sql, observer)`` of every subscriber: ``per`` spellings of
    each query, in a seeded order."""
    subs = [(_spelling(sql, k % 16), node) for sql, node in queries
            for k in range(per)]
    order = np.random.default_rng(seed + 1).permutation(len(subs))
    return [subs[int(i)] for i in order]


def subs_drive(subs, layout, trace, cut_table, full_table, subscribers,
               batch: bool = True) -> dict:
    """Register ``subscribers`` with a ``subs.SubsManager`` over
    ``layout`` and ``trace``'s universe, primed on ``cut_table``, then
    one step on ``full_table``. ``subs`` is a subscription package (this
    port's, or the JAX package's for its pins). Returns the manager,
    the initial events of each new matcher, the step's events and the
    host seconds of the prime and the step."""
    mgr = subs.SubsManager(subs.LayoutAdapter(layout=layout),
                           subs.TraceUniverse(trace), batch=batch)
    initial = []
    t0 = time.perf_counter()
    for sql, node in subscribers:
        m, first = mgr.get_or_insert(sql, node, cut_table)
        if first is not None:
            initial.append((m.id, first))
    prime_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = mgr.step(full_table)
    step_s = time.perf_counter() - t0
    return {"manager": mgr, "initial": initial, "events": events,
            "prime_s": prime_s, "step_s": step_s}


def subs_record(run: dict) -> dict:
    """A population run's outcome as its pin holds it: the digests of
    the initial events and of the step's events, their counts, and the
    rows the initial scans matched."""
    step = {sid: [[e.kind, e.rowid, e.cells, e.change_id] for e in evs]
            for sid, evs in sorted(run["events"].items())}
    return {
        "initial": _json_digest(run["initial"]),
        "step": _json_digest(step),
        "matchers": len(run["manager"]),
        "initial_rows": sum(sum("row" in e for e in ev)
                            for _, ev in run["initial"]),
        "step_events": sum(len(v) for v in step.values()),
    }


def subs_views(run: dict) -> dict:
    """Each matcher's rows after the step, rebuilt from what it emitted
    alone (its initial rows, then the step's inserts, updates and
    deletes): ``{sub_id: sorted cells}``."""
    views = {}
    for sid, first in run["initial"]:
        rows = {e["row"][0]: e["row"][1] for e in first if "row" in e}
        for e in run["events"].get(sid, ()):
            if e.kind == "delete":
                rows.pop(e.rowid, None)
            else:
                rows[e.rowid] = e.cells
        views[sid] = sorted(rows.values(), key=repr)
    return views


def subs_disagreements(run: dict) -> list:
    """The queries whose matchers on different observers hold different
    rows after the step (at convergence every node holds one table, so
    there should be none)."""
    by_sql: dict = {}
    mgr = run["manager"]
    for sid, rows in subs_views(run).items():
        sql = mgr.get(sid).select.normalized()
        by_sql.setdefault(sql, []).append(rows)
    return sorted(sql for sql, views in by_sql.items()
                  if any(v != views[0] for v in views[1:]))


def subs_oracle_mismatches(mgr, table) -> int:
    """Rows where a plain matcher's mask on ``table`` differs from
    ``eval_predicate_py`` (the host SQL oracle, independent of the rank
    compile) over its observer's decoded cells: live rows (odd causal
    length); a never-written cell reads as NULL, or as its column's
    default where the universe interns online (a closed trace universe
    holds no rank for a default, so the matcher bakes none)."""
    from corro_sim_torch.core.crdt import NEG
    from corro_sim_torch.subs.manager import Matcher
    from corro_sim_torch.subs.query import eval_predicate_py

    lay, uni = mgr.layout, mgr.universe
    bad = 0
    for m in list(mgr._by_id.values()):
        if type(m) is not Matcher:
            continue
        match, _ = m._evaluate(table)
        t = m.select.table
        rows = slice(m._start, m._start + m._cap)
        vr = table.vr[m.node, rows].cpu().numpy()
        cl = table.cl[m.node, rows].cpu().numpy()
        cols = {c: lay.col_index(t, c) for c in lay.table_columns(t)}
        want = np.zeros(m._cap, bool)
        for s in np.nonzero(cl % 2 == 1)[0]:
            key = lay.row_key(m._start + int(s))
            env = dict(zip(lay.pk_columns(t), key[1] if key else ()))
            for c, ci in cols.items():
                r = int(vr[s, ci])
                if r != NEG:
                    env[c] = uni.decode(r)
                else:
                    env[c] = (lay.column_default(t, c)
                              if hasattr(uni, "rank") else None)
            want[s] = (m.select.where is None
                       or eval_predicate_py(m.select.where, env.get))
        bad += int((want != match).sum())
    return bad


# ------------------------------------------------ the live cluster
# chip_smoke.py's live phases. "config1" is the JAX package's config 1
# (corro_sim_torch.benchmarks.config1_run): CONFIG1_PINS holds the JAX
# package's converged round and the run_digest of its final state
# (leaves only) from the same recipe on the CPU, at 3 agents and at the
# 64 of the north-star bench's devcluster leg, 1000 INSERTs each
# (tests/test_torch_cluster.py::jax_config1_pins holds the recipe).
CONFIG1_INSERTS = 1000
CONFIG1_PINS = {
    3: (52,
        "5fb420ad14d8e412d4b4cd34ce260dd66d41f012392e8383dd9d647965ab6d34"),
    64: (20,
         "e44c5a08b75524ee45326302624c4b7ea5919bdf4bca66fb44b8edfcba98e076"),
}

# "live_digests" and "live_10k": a LiveCluster over the Consul schema at
# LIVE_KEYS row slots per table (subs_capacities: 512 rows x 6 columns,
# 3 072 cells, so the sync sweep's merge runs the kernel on the card)
# with config 0's SWIM and sync knobs (slice_config(swim=True)), driven
# through its public API only: seeded SQL transactions from the writer
# nodes in waves, config 6's live-half population of 1024 subscribers
# (subs_queries / subs_subscribers) attached after the first wave,
# nodes down and rejoined, a scenario armed and cleared at 256 nodes,
# reconcile_gaps, run_until_converged, a few more ticks, then a
# checkpoint saved and warm-booted and ticked again.
LIVE_SEED = 0
LIVE_KEYS = 256
LIVE_PIN_NODES = 256  # where the JAX package ran "live_digests"
LIVE_WAVE_TICKS = 2  # rounds ticked after each wave of transactions
LIVE_TAIL_TICKS = 4  # rounds ticked after convergence, and after the boot
LIVE_MAX_ROUNDS = 1024
LIVE_OVERRIDES = dict(
    log_capacity=256, pend_slots=8, fanout=2, sync_interval=8,
    sync_adaptive=True, sync_floor_rounds=1, sync_actor_topk=128,
    sync_cap_per_actor=1, sync_req_actors=128, sync_need_sample=64,
    sync_deal_probes=0, swim_enabled=True, swim_suspect_rounds=6,
    swim_interval=4, narrow_state=True,
)
# the phases' shapes: writers x transactions per writer, nodes taken
# down (never writers) at wave `down_at` for at least `down_rounds`
# rounds, and the waves a lossy scenario stays armed
LIVE_DIGESTS_RUN = dict(writers=64, per_writer=8, down=4, down_at=4,
                        down_rounds=8, scenario=(1, 3))
LIVE_10K_RUN = dict(writers=128, per_writer=8, down=8, down_at=2,
                    down_rounds=16, scenario=None)

# What the JAX package's run on the CPU of chip_smoke.py's "live_digests"
# reports (tests/test_torch_cluster.py::jax_live_pins holds the recipe):
# live_record at LIVE_PIN_NODES nodes.
LIVE_PINS = {
    'converged_round': 38,
    'rounds': 58,
    'state':
        '8a8ad95ac58e77dad787bd28bf1726a4652caa219c1e6435d7ecc53127158252',
    'warm_state':
        'a6c23803480e0200fa16896f175a941a703d971c38d5e2dcd9ac276ec3a32e6e',
    'initial':
        'a7bdbe08878b8570acd9360d2b3bae1a6a2bf75eea7acbba05598096b1311656',
    'events':
        'ff655fc96bd129c4a68a2c67e3210393157fe6e5136bc4c9c75fc2349252064a',
    'event_count': 27584,
    'outcomes':
        'cf1a39fb63f800f3b17d0881a012d190f6ee677ae871c211446903d9b233ace5',
    'totals':
        '28bc26d18803d48245bdf0008464f1bd872cf0e8b768bb3e3a139ed18311d7c8',
    'flight':
        '446d97c649e79b6ae8c12ac2ecf8673f9f6cde81d8e8c919ddaa0774d489dcf3',
    'rejoined': [
        {'node': 31, 'alive': True, 'incarnation': 1},
        {'node': 66, 'alive': True, 'incarnation': 1},
        {'node': 75, 'alive': True, 'incarnation': 1},
        {'node': 211, 'alive': True, 'incarnation': 1},
    ],
    'reconciled': {'entries_reconciled': 0, 'actors_reconciled': 0},
}


def _live_statement(rng, keys: int, p: np.ndarray) -> str:
    """One write statement on a Zipf(1.1) key of either Consul table:
    INSERT (a whole row), UPDATE by pk (plain values, or an expression),
    a predicate UPDATE, or DELETE by pk."""
    k = int(rng.choice(keys, p=p))
    node = f"node-{k % 32}"
    ts = int(rng.integers(1_000_000))
    kind = rng.choice(5, p=[0.5, 0.2, 0.1, 0.05, 0.15])
    if rng.random() < 0.5:
        where = f"node = '{node}' AND id = 'svc-{k}'"
        if kind == 0:
            tags = _TAGS[int(rng.integers(len(_TAGS)))]
            return (
                "INSERT INTO consul_services (node, id, name, tags, meta, "
                f"port, address, updated_at) VALUES ('{node}', 'svc-{k}', "
                f"'svc-{int(rng.integers(10))}{k % 7}', '{tags}', "
                f"'{{\"app_id\": {int(rng.integers(100))}}}', "
                f"{8000 + int(rng.integers(64))}, '10.0.{k // 8}.{k % 8}', "
                f"{ts})")
        if kind == 1:
            return (f"UPDATE consul_services SET port = "
                    f"{8000 + int(rng.integers(64))}, updated_at = {ts} "
                    f"WHERE {where}")
        if kind == 2:
            return f"UPDATE consul_services SET port = port + 1 WHERE {where}"
        if kind == 3:
            return (f"UPDATE consul_services SET updated_at = {ts} WHERE "
                    f"port >= {8000 + int(rng.integers(64))} AND "
                    f"name LIKE 'svc-{int(rng.integers(10))}%'")
        return f"DELETE FROM consul_services WHERE {where}"
    where = f"node = '{node}' AND id = 'chk-{k}'"
    status = _STATUS[int(rng.integers(3))]
    code = (200, 500, 503)[int(rng.integers(3))]
    if kind == 0:
        return (
            "INSERT INTO consul_checks (node, id, service_id, service_name, "
            f"name, status, output, updated_at) VALUES ('{node}', 'chk-{k}', "
            f"'svc-{k}', 'svc-{int(rng.integers(32))}', 'serfHealth', "
            f"'{status}', 'HTTP GET: {code}', {ts})")
    if kind in (1, 2):
        return (f"UPDATE consul_checks SET status = '{status}', output = "
                f"'HTTP GET: {code}' WHERE {where}")
    if kind == 3:
        return ("UPDATE consul_checks SET output = 'HTTP GET: 503' WHERE "
                f"status = 'critical' AND service_name = "
                f"'svc-{int(rng.integers(32))}'")
    return f"DELETE FROM consul_checks WHERE {where}"


def live_transactions(seed: int, n: int, writers: int, per_writer: int,
                      keys: int = LIVE_KEYS) -> tuple:
    """The seeded transaction stream: ``(writer nodes, waves)``, each
    wave a list of ``(node, statements)`` holding each writer's next
    transaction of 1-4 statements. Hot keys are written by several
    nodes (LWW conflicts)."""
    rng = np.random.default_rng(seed)
    nodes = sorted(int(x) for x in rng.choice(n, writers, replace=False))
    p = 1.0 / np.power(np.arange(1, keys + 1, dtype=np.float64), 1.1)
    p /= p.sum()
    waves = [[(node, [_live_statement(rng, keys, p)
                      for _ in range(int(rng.integers(1, 5)))])
              for node in nodes] for _ in range(per_writer)]
    return nodes, waves


def live_down_nodes(seed: int, n: int, writers, count: int) -> list:
    """``count`` seeded nodes outside the writers, to take down."""
    rng = np.random.default_rng(seed + 2)
    free = np.setdiff1d(np.arange(n), np.asarray(writers))
    return sorted(int(x) for x in rng.choice(free, count, replace=False))


def live_event_record(ev) -> list:
    """A subscription event as its pin holds it."""
    return [ev.kind, ev.rowid, ev.cells, ev.change_id, ev.round]


def live_drive(backend, n: int, *, writers: int, per_writer: int,
               down: int, down_at: int, down_rounds: int, scenario,
               subscribers: list, ckpt_path: str, wrap_ticks=None,
               **cluster_kw) -> dict:
    """One live run on ``backend`` (a namespace holding ``LiveCluster``,
    ``save_checkpoint`` and ``load_checkpoint``: this port's, or the JAX
    package's for its pins). ``wrap_ticks``: a context manager factory
    wrapped around the ticks after convergence (chip_smoke.py counts
    the host syncs there). Returns the cluster, the warm-booted one,
    the subscribers' initial events and queues, each statement's
    outcome and the host seconds of the run's parts."""
    from corro_sim_torch.schema import consul_schema_sql

    secs = defaultdict(float)
    t0 = time.perf_counter()
    c = backend.LiveCluster(
        consul_schema_sql(), num_nodes=n, seed=LIVE_SEED,
        capacities=subs_capacities(LIVE_KEYS),
        cfg_overrides=dict(LIVE_OVERRIDES), **cluster_kw)
    secs["build"] = time.perf_counter() - t0
    wnodes, waves = live_transactions(LIVE_SEED, n, writers, per_writer)
    gone = live_down_nodes(LIVE_SEED, n, wnodes, down)
    outcomes, initial, queues, rejoined = [], [], [], []
    down_round = None

    def submit(wave):
        for node, stmts in wave:
            t = time.perf_counter()
            try:
                res = c.execute(stmts, node=node, wait=False)
                outcomes.append([r["rows_affected"] for r in res["results"]])
            except ValueError as e:  # ExecError in both packages
                outcomes.append([type(e).__name__, str(e)])
            secs["execute"] += time.perf_counter() - t
            secs["transactions"] += 1

    for w, wave in enumerate(waves):
        if scenario is not None and w == scenario[0]:
            c.load_scenario("lossy", rounds=64)
        if scenario is not None and w == scenario[1]:
            c.clear_scenario()
        if w == down_at:
            for node in gone:
                c.set_alive(node, False)
            down_round = c._rounds_ticked
        submit(wave)
        t = time.perf_counter()
        c.tick(LIVE_WAVE_TICKS)
        secs["wave_ticks"] += time.perf_counter() - t
        if w == 0:
            t = time.perf_counter()
            for sql, node in subscribers:
                sid, first, q = c.subscribe_attached(sql, node)
                initial.append((sid, first))
                queues.append(q)
            secs["subscribe"] = time.perf_counter() - t
    if down_round is not None:
        left = down_rounds - (c._rounds_ticked - down_round)
        if left > 0:
            c.tick(left)
        rejoined = [c.rejoin(node) for node in gone]
    reconciled = c.reconcile_gaps()
    t = time.perf_counter()
    r0 = c._rounds_ticked
    converged = c.run_until_converged(max_rounds=LIVE_MAX_ROUNDS)
    secs["converge"] = time.perf_counter() - t
    secs["converge_rounds"] = c._rounds_ticked - r0
    t = time.perf_counter()
    with (wrap_ticks() if wrap_ticks is not None
          else contextlib.nullcontext()):
        c.tick(LIVE_TAIL_TICKS)
    secs["tail_ticks"] = time.perf_counter() - t
    t = time.perf_counter()
    backend.save_checkpoint(c, ckpt_path)
    secs["save_checkpoint"] = time.perf_counter() - t
    t = time.perf_counter()
    warm = backend.load_checkpoint(ckpt_path, **cluster_kw)
    secs["load_checkpoint"] = time.perf_counter() - t
    warm.tick(LIVE_TAIL_TICKS)
    return {"cluster": c, "warm": warm, "initial": initial,
            "queues": queues, "subscribers": subscribers,
            "outcomes": outcomes, "rejoined": rejoined,
            "reconciled": reconciled, "converged_round": converged,
            "down_nodes": gone, "writers": wnodes,
            "checkpoint_bytes": os.path.getsize(ckpt_path),
            "host_seconds": dict(secs)}


def live_record(run: dict, leaves, warm_leaves) -> dict:
    """A live run's outcome as its pin holds it: the converged round,
    the run_digest of the final state's ``leaves`` and of the
    warm-booted cluster's after its ticks, the digests of every
    subscriber's initial events and event stream, of the statements'
    outcomes, of ``metrics_totals()``, of the flight record, and the
    admin calls' results."""
    c = run["cluster"]
    return {
        "converged_round": run["converged_round"],
        "rounds": c._rounds_ticked,
        "state": run_digest(leaves, {}),
        "warm_state": run_digest(warm_leaves, {}),
        "initial": _json_digest(run["initial"]),
        "events": _json_digest([[live_event_record(e) for e in q]
                                for q in run["queues"]]),
        "event_count": sum(len(q) for q in run["queues"]),
        "outcomes": _json_digest(run["outcomes"]),
        "totals": _json_digest(c.metrics_totals()),
        "flight": hashlib.sha256(
            c.flight.to_ndjson().encode()).hexdigest(),
        "rejoined": run["rejoined"],
        "reconciled": run["reconciled"],
    }


def live_folded_mismatches(run: dict) -> list:
    """The subscribers whose initial rows, folded with their events on
    the host, differ from their query's rows on the cluster now."""
    c = run["cluster"]
    bad = []
    for (sid, first), q, (sql, node) in zip(run["initial"], run["queues"],
                                          run["subscribers"]):
        rows = {e["row"][0]: e["row"][1] for e in first if "row" in e}
        for e in q:
            if e.kind == "delete":
                rows.pop(e.rowid, None)
            else:
                rows[e.rowid] = e.cells
        _, want = c.query_rows(sql, node)
        if sorted(rows.values(), key=repr) != sorted(want, key=repr):
            bad.append(sid)
    return bad


def live_oracle_rows(cluster, sql: str, node: int) -> list:
    """A plain single-table query's rows on ``node`` by the host SQL
    oracle: the node's live rows decoded cell by cell (a never-written
    cell reads as its column's default), filtered by
    ``eval_predicate_py`` and projected as ``query_rows`` projects (pk
    columns first)."""
    from corro_sim_torch.core.crdt import NEG
    from corro_sim_torch.subs.query import eval_predicate_py, parse_query

    sel = parse_query(sql)
    lay, uni = cluster.layout, cluster.universe
    t = lay.schema.tables[sel.table]
    start, _cap = lay._range(sel.table)
    used = lay._used[sel.table]
    vr = cluster.state.table.vr[node, start:start + used].cpu().numpy()
    cl = cluster.state.table.cl[node, start:start + used].cpu().numpy()
    cols = [c.name for c in t.value_columns]
    rows = []
    for s in np.nonzero(cl % 2 == 1)[0]:
        key = lay.key_of(start + int(s))
        env = dict(zip(t.pk, key[1]))
        for c in t.value_columns:
            r = int(vr[s, lay.col_index(sel.table, c.name)])
            env[c.name] = uni.decode(r) if r != NEG else c.default_value
        if sel.where is None or eval_predicate_py(sel.where, env.get):
            out = [env[p] for p in t.pk]
            out += [env[c] for c in (sel.columns or cols) if c not in t.pk]
            rows.append(out)
    return rows


# ------------------------------------------------- the serving surfaces
# chip_smoke.py's serving phases. "config6_live" is config 6's live half
# exactly as the JAX package defines it (benchmarks.config6_live_run:
# the Zipf 1.1 + churn-storm schedule at 256 nodes, 64 matchers, 1024
# subscribers, 64 latency-tracked, 4 direct queries per round, settle
# 512; the schedule touches 2046 keys, 4 092 cells, so its merges take
# the scatter arm). "serve_256" is the same schedule with the one-shot
# queries rotating over direct, HTTP and pgwire (SERVE_RUN) on 2048 row
# slots (4 096 cells: the merge kernel runs on the card). The pins are
# the JAX package's CPU runs of the same recipe
# (tests/test_torch_live_load.py::jax_config6_live_pins holds it),
# recorded by live_load_record.
CONFIG6_LIVE_NODES = 256
SERVE_RUN = dict(http=True, pg=True, default_capacity=2048)
LIVE_LOAD_FIELDS = ("writes", "deletes", "observed", "coalesced",
                    "settle_rounds", "drained", "matchers", "subscriptions",
                    "queries")
LIVE_LOAD_QUANTILES = ("p50", "p90", "p99", "max", "count")


def live_load_record(report: dict, leaves: dict) -> dict:
    """A live-load run's deterministic outcome, as its pin holds it: the
    report's counts, its sub-delivery quantiles in rounds, and the
    run_digest of the final table planes (``leaves`` named as
    ``convert.state_to_numpy`` names them; only ``table.*`` is read)."""
    rec = {k: report[k] for k in LIVE_LOAD_FIELDS}
    rec["latency_rounds"] = {k: report["latency_rounds"][k]
                             for k in LIVE_LOAD_QUANTILES}
    rec["table"] = run_digest(
        {k: v for k, v in leaves.items() if k.startswith("table.")}, {})
    return rec


CONFIG6_LIVE_PINS = {
    'writes': 5668, 'deletes': 383, 'observed': 87472,
    'coalesced': 250768, 'settle_rounds': 207, 'drained': True,
    'matchers': 64, 'subscriptions': 1024, 'queries': {'direct': 256},
    'latency_rounds': {'p50': 8.0, 'p90': 202.0, 'p99': 202.0,
                       'max': 202.0, 'count': 87472},
    'table':
        '6d061a1c0412c3905555d4f711b30d527335a2fa10ee3150473117f461e7a294',
}
# "serve_256": the same schedule and outcome, the one-shot queries spread
# over the three surfaces, and the table planes at 2048 row slots
SERVE_256_PINS = dict(
    CONFIG6_LIVE_PINS,
    queries={'direct': 86, 'http': 85, 'pg': 85},
    table='58ce4179f6412d997fac8ef5dda7081cc55e95a302d2792860de764fdad9d00c',
)


# "serve_10k" (and the card test over 48 nodes): one transaction, one
# query on three surfaces and one subscription event through the real
# servers of a Consul-schema LiveCluster
SERVE_QUERY = ("SELECT node, id, port FROM consul_services "
               "WHERE id = 'svc-serve'")
SERVE_WRITE = ("INSERT INTO consul_services (node, id, name, tags, meta, "
               "port, address, updated_at) VALUES ('node-serve', "
               "'svc-serve', 'serve', '', '', 8443, '10.9.9.9', 1)")


def serve_check(cluster, writer: int, reader: int, *, scrape_wrap=None,
                max_rounds: int = 4096) -> dict:
    """Serve ``cluster`` over HTTP and pgwire and drive one write through
    it: an HTTP subscription to :data:`SERVE_QUERY` on ``reader``, the
    :data:`SERVE_WRITE` transaction over HTTP on ``writer``,
    ``run_until_converged``, the subscription's event, the query over
    HTTP, over pgwire and directly on ``reader``, ``/v1/cluster/members``,
    ``/v1/table_stats`` and one ``/metrics`` scrape (inside
    ``scrape_wrap()``, a context manager factory, when given). Returns
    what each surface answered and the host seconds of each part."""
    import urllib.request

    from corro_sim_torch.api.http import ApiServer
    from corro_sim_torch.api.pg import PgServer, SimplePgClient
    from corro_sim_torch.client import ApiClient

    out, secs = {}, {}
    with ApiServer(cluster) as api, PgServer(cluster) as pg:
        client = ApiClient(api.addr, timeout=600.0)
        sub = client.subscribe(SERVE_QUERY, node=reader)
        out["sub_initial"] = sub.events(2)
        t = time.perf_counter()
        resp = client.execute([SERVE_WRITE], node=writer)
        secs["http_execute"] = time.perf_counter() - t
        out["execute"] = {
            "version": resp["version"],
            "results": [{k: v for k, v in r.items() if k != "time"}
                        for r in resp["results"]]}
        t = time.perf_counter()
        out["converged_round"] = cluster.run_until_converged(
            max_rounds=max_rounds)
        secs["converge"] = time.perf_counter() - t
        out["sub_event"] = sub.events(1)[0]
        sub.close()
        t = time.perf_counter()
        out["http_rows"] = list(client.query_rows(SERVE_QUERY, node=reader))
        secs["http_query"] = time.perf_counter() - t
        pgc = SimplePgClient(*pg.addr, database=f"node{reader}")
        t = time.perf_counter()
        fields, rows, _tags, errors = pgc.query(SERVE_QUERY)
        secs["pg_query"] = time.perf_counter() - t
        pgc.close()
        out["pg_rows"] = [[f for f, _ in fields], rows, errors]
        t = time.perf_counter()
        out["direct_rows"] = list(cluster.query_rows(SERVE_QUERY, reader))
        secs["direct_query"] = time.perf_counter() - t
        out["members"] = client.members()
        out["table_stats"] = client.table_stats()
        wrap = scrape_wrap() if scrape_wrap else contextlib.nullcontext()
        with wrap:
            t = time.perf_counter()
            with urllib.request.urlopen(f"{api.url}/metrics",
                                        timeout=600) as r:
                out["metrics"] = r.read().decode()
            secs["scrape"] = time.perf_counter() - t
    out["seconds"] = secs
    return out


def serve_agrees(out: dict) -> bool:
    """The three surfaces gave the same rows, and the one row is the
    write; the subscriber saw it as an insert."""
    cols, rows = out["direct_rows"]
    return (out["http_rows"] == [cols, rows] and out["pg_rows"][2] == []
            and out["pg_rows"][:2] == [cols, rows]
            and rows == [["node-serve", "svc-serve", 8443]]
            and out["sub_event"]["change"][0] == "insert"
            and out["sub_event"]["change"][2] == rows[0])

# The replay fixtures: (path in the repository, config overrides on the
# trace's suggest_config()); replayed with max_rounds=256. The first is
# the JAX package's tests/test_replay_parity.py case.
REPLAY_CASES = {
    "replay_parity": ("tests/fixtures/replay_parity.ndjson", dict(
        seqs_per_version=4, chunks_per_version=2, fanout=2,
        sync_interval=2, pend_slots=8)),
    "flyio_small": ("tests/fixtures/traces/flyio_small.ndjson", {}),
}
REPLAY_MAX_ROUNDS = 256
# the round at which each replay converges, as the JAX package's does
REPLAY_ROUNDS = {"replay_parity": 5, "flyio_small": 4}

# the SWIM-on digest runs (digest_config, DIGEST_RUN_ARGS, slice_schedule)
SWIM_DIGEST_CASES = ("config0_1024", "windowed_256")


def digest_config(case: str) -> SimConfig:
    """The configurations of the SWIM-on digests: config 0 at 1024 nodes,
    and config 0's shape at 256 nodes with windowed SWIM. (The config-3
    digest's run is ``config3_config(1000)``.)"""
    if case == "config0_1024":
        return slice_config(1024, swim=True)
    return dataclasses.replace(
        slice_config(256, swim=True), swim_view_size=16,
        swim_payload_members=8, swim_interval=1,
    )


# run_sim arguments of the digest runs, with slice_schedule()
DIGEST_RUN_ARGS = dict(max_rounds=24, chunk=8, seed=0,
                       stop_on_convergence=False)

# sha256 (run_digest) of the state and metric series after the digest
# runs. Made with the JAX package on the CPU: run_sim of digest_config(
# case) from init_state(cfg, seed=0) — the SWIM cases under
# slice_schedule() and DIGEST_RUN_ARGS, config 3 under config3_schedule()
# and CONFIG3_RUN_ARGS, config 6 with workload=config6_workload(1000) and
# CONFIG6_RUN_ARGS, to convergence, and each CONFIG_DIGEST_CASES run as
# config_digest_case(case) sets it up, each SLICE8_DIGEST_CASES run
# (slice8_config(case) under slice_schedule() and RUN_ARGS), and each
# FAULT_DIGEST_CASES run as fault_digest_run(case) sets it up, the
# uninterrupted run of token_case() ("token_jax_64", sequential) — and
# replay of each REPLAY_CASES fixture; the state flattened by jax.tree_util.keystr (leading dot
# dropped) and the metrics as run_sim or replay returned them. The port
# matches them on every device. The config-6 digests leave out the "gap"
# series (CONFIG6_DIGEST_EXCLUDE), and so does config 4's: their lag sums
# pass 2**24 (at 1000 nodes in 13 rounds), where the JAX package's float32
# sum rounds and the port's int64 sum is exact (ROADMAP.md queue 3).
DIGESTS = {
    "config0_1024":
        "e5e2f46901a6fe6edce729ad662605a2b76c6d67409b818e09cf1ea349680140",
    "windowed_256":
        "3ff3f989bbfe501b20313b9db490ac3b265180d9e129f68acb5a28a9caea3860",
    "config3_1000":
        "76478f214e3b261a2736b916e53c707a19f191cbabcadb6150851132241a438b",
    "config6_1000":
        "0e6304baae4d36fbde19efac54491cbbb4097a8fd87af43edbcd2d59f173e9c5",
    "replay_parity":
        "beb02da908031648cbfd69e7084c7148922f3051c27bc3185cf607ea235db26c",
    "flyio_small":
        "4e2fab708f86fe0a71fd2ef7ac625dd554bb1a06de22111f710a63e527673f6d",
    "config4_1024":
        "43b0f48aaff4ab96f03796edf113c2fbfa6c4ee93d360aba6f89e78a4cac432a",
    "config5_2048":
        "516cee598a706178380ce84a11df73e48e1b03b4958d6806efa8a176c5f18505",
    "config7_1536":
        "22ade412d6e3586d2b041ec3848daf1fc4dac719ca16098b174af2e9cd3fa3a4",
    "config6_4000":
        "6dab0d8ae7eb9497c3d5ced2b804a00c2e69edb04b5320aefa26cdb18254ed8e",
    "soak:lossy:p=0.1@0":
        "c5dd76ec08427872de719e00997d13e987ebfc61a552b52ca630d14f8be3609a",
    "soak:churn:rate=0.05@0":
        "cc97908c2a9d4851fcb7dd0837d2134fbd123f0ae0e48800a811c74de8d8b772",
    "soak:crash_amnesia@0":
        "f96607f11a2208398e72dde089ca7c09085a315b7e828351b153a12e6dca841f",
    "soak:clock_skew@0":
        "e24604cb57eefad8d07bba3e03163caab1ae1328bdb6711793c8fc731823554d",
    "soak:lossy:p=0.1@1":
        "cc3fdff93292b80324f424fa8522ceadb9f901951b5438cbd24a8e2b04981e49",
    "soak:churn:rate=0.05@1":
        "cb8390202f7a58278d94ebeb465892e22bbc6f733046cdccac635b848c967f30",
    "soak:crash_amnesia@1":
        "acab149d86de9c278d48a2db153fa128863a9dc76f72f2ab72c13ca0720adda3",
    "soak:clock_skew@1":
        "d7396a2e1d60ebf868f62f55ae0ce73b67a3c3b80a40c8779d83ae8f63c8b78e",
    "soak:duplicating@0":
        "bbabd72380224b8304b001a4bc27bbdd3f092c04ce5f1b0550369dafaa604f89",
    "soak:burst@0":
        "daec15ad7a4ae63bf2fc78713e7764a1405a6cf6e93144b55d9d08b0ca3d5022",
    "soak:rolling_restart@0":
        "e6b4a82d28728f334d77693f5ca37ceaa28a5666d9fecf92383b74dbb3740218",
    "soak:flapper@0":
        "55c7829729d547b21939f7d9e7abd403714d1d77e498a4da1342dc6f4c69aa36",
    "soak:split_brain_heal@0":
        "32a36c37bde7c455de2e0fc8e47dd812f96a46cb9e7dd56ef58c1f572e51cab2",
    "soak:stale_rejoin@0":
        "630742e6b09d7c543c60041dbcbcb38702916e1addf5866f1c592037e3a83809",
    "soak:stragglers@0":
        "f8f9e71f13505932ed6763a06a816cac227fb0cb35a3ae89a6debf8885577ef3",
    "soak:blackhole_one_way@0":
        "3a62173ee4273e357bbda609d29c59da0f8b7b5caac0ddfb6c239ae1f0abc567",
    "soak:lossy:p=0.1@0+latency":
        "99bc38a943194f320cf1919038c9de439f4012136a197b3acd4287168f5d64be",
    "latency_256":
        "cc926079e448a2aede507fd4a86451fa3f52e2bc9d095ce059f30768291f2b34",
    "latency_1000":
        "2854f8fdecb8b135d243dc3bad177b8e12ad6f49798b94813e44eed8df4946fd",
    "legacy_256":
        "e272e37f29c68d20108c547d0ada6712194c435acaa741fe43ddad575e5e86cb",
    "legacy_1000":
        "c1db81c6ff0b4561e11ecd75668f452f2d34711d780b67d9d2c63d30e419bd09",
    "deal_256":
        "23dd78b0c1aad86c591f4d4fbe4f0f0f33ddc115abe8cd94be164e0ae7eadc28",
    "deal_1000":
        "29b075e838d10d8100cb3865e9475ea844823d2172632c753ee22d32624e74d1",
    "token_jax_64":
        "076de31056a2995462f4bbfa9d3c66f04d8561136a8937a9efab6ef143db62a4",
}
CONFIG6_DIGEST_EXCLUDE = ("gap",)


def run_digest(leaves: dict, metrics: dict, exclude=()) -> str:
    """sha256 over the state leaves in sorted path order, then the metric
    series in sorted name order, leaving out the metrics named in
    ``exclude``; each entry contributes its name, numpy dtype, shape and
    bytes."""
    h = hashlib.sha256()
    metrics = {k: v for k, v in metrics.items() if k not in exclude}
    for group in (leaves, metrics):
        for name in sorted(group):
            a = np.ascontiguousarray(group[name])
            h.update(f"{name}|{a.dtype.str}|{a.shape}|".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def partition_upper_half(r: int, num: int) -> np.ndarray:
    """The upper half of the cluster cut off for rounds 4-11."""
    p = np.zeros(num, np.int32)
    if 4 <= r < 12:
        p[num // 2:] = 1
    return p


def slice_schedule() -> Schedule:
    return Schedule(write_rounds=8, part_fn=partition_upper_half)


def _launches_in(events, name: str) -> tuple[int, int]:
    """``(inside, total)``: host-side kernel launch calls made inside the
    host-side profiler ranges called ``name``, and in all. (The profiler
    also records each range on the device's timeline, spanning the
    range's kernels; those spans are not counted.)"""
    from bisect import bisect_left, bisect_right

    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    launch = sorted(e.time_range.start for e in host
                    if e.name.startswith("cudaLaunchKernel"))
    inside = sum(
        bisect_right(launch, e.time_range.end)
        - bisect_left(launch, e.time_range.start)
        for e in host if e.name == name
    )
    return inside, len(launch)


@contextlib.contextmanager
def _swim_ranges():
    """Mark each SWIM tick as a profiler range called ``swim_tick``."""
    fn = step_mod.swim_step

    @functools.wraps(fn)
    def marked(*a, **kw):
        with torch.profiler.record_function("swim_tick"):
            return fn(*a, **kw)

    step_mod.swim_step = marked
    try:
        yield
    finally:
        step_mod.swim_step = fn


# rounds of a soak cell that --soak profiles
SOAK_PROFILE_ROUNDS = 64


def _run(cfg, device, workload=None, soak=None):
    """One seeded run of a cell: config 3 (multi-chunk) and config 6 (a
    workload) over their profiled windows, a soak cell (config 0 under
    the scenario ``soak``) over its first ``SOAK_PROFILE_ROUNDS``
    rounds, the north-star cells to convergence."""
    if soak is not None:
        args = dict(SOAK_ARGS, max_rounds=SOAK_PROFILE_ROUNDS)
        return run_soak(cfg, soak, device=device, invariants=False,
                        scorecard=False, stop_on_convergence=False,
                        **args).result
    state = init_state(cfg, seed=0, device=device)
    if workload is not None:
        return run_sim(cfg, state, device=device, workload=workload,
                       **CONFIG6_PROFILE_ARGS)
    if cfg.chunks_per_version > 1:
        return run_sim(cfg, state, config3_schedule(), device=device,
                       **CONFIG3_PROFILE_ARGS)
    return run_sim(cfg, state, slice_schedule(), device=device, **RUN_ARGS)


@contextlib.contextmanager
def _stage_timers(device, totals, counts):
    def sync():
        torch.cuda.synchronize(device)

    saved = []
    for mod, name in STAGES:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        @functools.wraps(fn)
        def timed(*a, _fn=fn, _name=name, **kw):
            sync()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            sync()
            totals[_name] += time.perf_counter() - t0
            counts[_name] += 1
            return out

        setattr(mod, name, timed)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _merge_bounds(cfg, device, workload=None, soak=None) -> list:
    """Run the cell with the sync sweep's merge wrapped; per launch, a
    dict of the merge's in-place and out-of-place work, its sector bytes
    and the mailbox's counts. The wrapper copies the pre-merge planes,
    which the merge consumes."""
    works = []
    merge = sync_mod.merge_grouped

    def counted(table, lanes, cap):
        n, r, c = table.cv.shape
        before = tuple(t.reshape(n, -1).clone() for t in
                       (table.cv, table.vr, table.site, table.cl))
        out = merge(table, lanes, cap)
        after = tuple(t.reshape(n, -1) for t in
                      (out.cv, out.vr, out.site, out.cl))
        valid = lanes[mk.LANE_VALID] != 0
        works.append({
            "in_place": mk.merge_work(before, lanes, cap, c, after),
            "out_of_place": mk.merge_work_out_of_place(before, lanes, cap,
                                                       c, after),
            "sector_bytes": mk.merge_sector_bytes(before, lanes, cap, c,
                                                  after),
            "valid_lanes": int(valid.sum()),
            "nodes_with_lanes": int(valid.view(n, cap).any(1).sum()),
            "rows_hit": int((mp.hit_rows(lanes, cap, c, r * c) >= 0).sum()),
            "rows_wiped": int((after[3] > before[3]).sum()),
        })
        return out

    sync_mod.merge_grouped = counted
    try:
        _run(cfg, device, workload, soak)
    finally:
        sync_mod.merge_grouped = merge
    return works


class _LateRead:
    """The sweep gate's device predicate, copied to the host only when
    the sweep is due."""

    def __init__(self, pred):
        self.pred = pred

    def resolve(self):
        return [self.pred.cpu().numpy()]


@contextlib.contextmanager
def _late_read():
    """The alternative to the early read, for the measurement: the step
    reads the gate's device predicate where the sweep is due (a blocking
    copy), as the step did before the early read."""
    start = step_mod.start_async_fetch
    step_mod.start_async_fetch = _LateRead
    try:
        yield
    finally:
        step_mod.start_async_fetch = start


def host_read(pairs: int) -> dict:
    """The early read of the sweep gate's device predicate (started where
    the predicate is computed, read where the sweep is due) against the
    late read (a blocking copy where the sweep is due), end to end:
    config 0 exactly at 10 000 nodes to convergence and config 6 at
    10 000 nodes over its first 128 rounds, ``pairs`` pairs each, in
    turns early, late, late, early; wall per round of each run."""
    device = torch.device("cuda")
    cells = {
        "config0": (slice_config(swim=True), None, slice_schedule, RUN_ARGS),
        "config6": (config6_config(), config6_workload(), Schedule,
                    CONFIG6_PROFILE_ARGS),
    }
    out = {}
    for name, (cfg, wl, sched, args) in cells.items():
        def run(variant):
            ctx = _late_read() if variant == "late" else (
                contextlib.nullcontext())
            with ctx:
                res = run_sim(cfg, init_state(cfg, seed=0, device=device),
                              sched(), device=device, workload=wl, **args)
            return res.wall_per_round_ms, res.pipeline, res.rounds

        run("early")  # warm-up: allocator growth, kernel build
        walls = {"early": [], "late": []}
        gates = {}
        for i in range(pairs):
            order = ("early", "late") if i % 2 == 0 else ("late", "early")
            for variant in order:
                ms, pipe, rounds = run(variant)
                walls[variant].append(ms)
                gates[variant] = {k: pipe[k] for k in (
                    "host_decided", "host_reads", "sweeps_run")}
        diff = [e - t for e, t in zip(walls["early"], walls["late"])]
        out[name] = {
            "nodes": cfg.num_nodes, "rounds": rounds,
            "wall_per_round_ms": walls, "gates": gates,
            "median_ms": {k: float(np.median(v)) for k, v in walls.items()},
            "early_minus_late_ms": diff,
            "early_faster_pairs": sum(d < 0 for d in diff),
        }
    return out


def launches_per_round(cfg: SimConfig, schedule: Schedule, rounds: int = 16,
                       device="cuda") -> dict:
    """Kernel launches per round and the device's busy share over the
    first ``rounds`` rounds of a seeded run, under ``torch.profiler``
    tracing the device only (host ops unrecorded, so the trace stays
    small)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = init_state(cfg, seed=0, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_sim(cfg, state, schedule, max_rounds=rounds, chunk=8,
                      seed=0, stop_on_convergence=False, device=device)
        torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    return {"rounds": res.rounds,
            "launches_per_round": len(kernels) / res.rounds,
            "profiled_wall_per_round_ms": wall_ms / res.rounds,
            "device_busy_share": _busy_ms(kernels) / wall_ms}


def _busy_ms(intervals) -> float:
    """Length of the union of (start, end) microsecond intervals, in ms."""
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def sweep_books(res, wall: float) -> dict:
    """A sweep's JSON books: clusters per second per device, walls, the
    gate counts, the occupancy block and curve, and the peak memory."""
    from corro_sim_torch.obs.lanes import fleet_occupancy

    occ = fleet_occupancy(res)
    return {
        "lanes": len(res.lanes), "rounds": res.rounds,
        "dispatches": res.dispatches,
        "clusters_per_second_per_device":
            res.clusters_per_second_per_device,
        "sweep_wall_s": res.wall_seconds, "wall_s": wall,
        "setup_s": res.compile_seconds, "sweeps": res.sweeps,
        "occupancy": {k: occ[k] for k in (
            "lanes", "dispatches", "executed_lane_rounds",
            "useful_lane_rounds", "wasted_frozen_lane_rounds",
            "occupancy_ratio")},
        "occupancy_curve": [
            {k: e[k] for k in ("lanes_active", "width", "pending",
                               "refills") if k in e}
            for e in occ["curve"]],
        "compaction": res.compaction, "pipeline": res.pipeline,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


def config8(seeds: int = 8, n: int = 256) -> dict:
    """Config 8 exactly (``corro_sim/benchmarks.py:1073-1258``,
    ``run_config_8``) on the card: the lanes in lockstep, then the same
    grid through the fleet scheduler at half the lane count, pipelined;
    then the grid's first lane run serially, whose wall times the lane
    count is the serial soak loop's estimate. Clusters per second per
    device, walls, occupancy and the frontier."""
    from corro_sim_torch.sweep import build_frontier
    from corro_sim_torch.sweep.engine import run_sweep

    plan = config8_plan(range(seeds), n=n)
    out = {"lanes": plan.num_lanes, "nodes_per_lane": n, "seeds": seeds,
           "scenarios": [lane.spec for lane in plan.lanes[::seeds]]}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lock = run_sweep(plan, **CONFIG8_SWEEP_ARGS, device="cuda")
    torch.cuda.synchronize()
    out["lockstep"] = sweep_books(lock, time.perf_counter() - t0)
    frontier = build_frontier(lock.lanes)
    out["frontier"] = frontier
    out["frontier_digest"] = frontier_digest(frontier)
    if n == 256 and seeds in CONFIG8_FRONTIERS:
        out["frontier_match"] = (out["frontier_digest"]
                                 == CONFIG8_FRONTIERS[seeds])
        out["lanes_match"] = sum(sweep_lane_record(lr)["match"]
                                 for lr in lock.lanes)
    width = max(1, plan.num_lanes // 2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    comp = run_sweep(plan, **CONFIG8_SWEEP_ARGS, device="cuda",
                     compact=True, width=width, pipeline=True)
    torch.cuda.synchronize()
    out["compact"] = dict(
        sweep_books(comp, time.perf_counter() - t0), width=width,
        matches_lockstep=all(
            a.converged_round == b.converged_round and a.rounds == b.rounds
            and a.poisoned == b.poisoned
            for a, b in zip(lock.lanes, comp.lanes)))
    del lock, comp
    ref = plan.lanes[0]
    t0 = time.perf_counter()
    serial = run_sim(ref.cfg, init_state(ref.cfg, seed=ref.seed,
                                         device="cuda"),
                     ref.scenario.schedule(), seed=ref.seed,
                     min_rounds=ref.min_rounds, device="cuda",
                     **CONFIG8_SWEEP_ARGS)
    torch.cuda.synchronize()
    out["serial_lane"] = {
        "lane": f"{ref.spec}@{ref.seed}", "wall_s": time.perf_counter() - t0,
        "sim_s": serial.wall_seconds, "setup_s": serial.setup_seconds,
        "converged_round": serial.converged_round,
        "loop_estimate_s": serial.wall_seconds * plan.num_lanes,
    }
    return out


def swim_churn(out_dir: str, sizes=tuple(SWIM_CHURN_PINS),
               device: str = "cuda") -> dict:
    """Config 0's churn soak (``SWIM_CHURN_SPEC``, ``SOAK_ARGS``, seed 0)
    on ``device`` at each size: the command line's ``soak --serial``
    report (its verdict and violations) and ``run_soak``'s rounds,
    violations and digest, each held to ``SWIM_CHURN_PINS``."""
    import contextlib
    import io

    from corro_sim_torch import cli
    from corro_sim_torch.convert import state_to_numpy

    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for n in sizes:
        conf = os.path.join(out_dir, f"config0_{n}.toml")
        with open(conf, "w") as f:
            f.write(sim_toml(soak_config(n)))
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([
                "--device", device, "soak", "--config", conf, "--serial",
                "--scenario",
                SWIM_CHURN_SPEC, "--rounds", str(SOAK_ARGS["rounds"]),
                "--write-rounds", str(SOAK_ARGS["write_rounds"]),
                "--chunk", str(SOAK_ARGS["chunk"]),
                "--max-rounds", str(SOAK_ARGS["max_rounds"]),
                "--seed", "0"])
        cli_s = time.perf_counter() - t
        rep = json.loads(buf.getvalue())["scenarios"][0]
        t = time.perf_counter()
        run = run_soak(soak_config(n), SWIM_CHURN_SPEC, device=device,
                       **SOAK_ARGS)
        res = run.result
        got = (res.rounds, res.converged_round,
               [(v["round"], v["invariant"], v["detail"])
                for v in run.invariants.report()["violations"]],
               run_digest(state_to_numpy(res.state), res.metrics))
        out[n] = {"cli_rc": rc, "cli_s": cli_s,
                  "cli_invariants": rep["invariants"],
                  "rounds_run": got[0], "converged_round": got[1],
                  "violations": got[2], "digest": got[3],
                  "match": got == SWIM_CHURN_PINS.get(n),
                  "cli_match": [(v["round"], v["invariant"], v["detail"])
                                for v in rep["invariants"]["violations"]]
                  == got[2],
                  "run_soak_s": time.perf_counter() - t,
                  "wall_per_round_ms": res.wall_per_round_ms}
        del run, res
        if device == "cuda":
            torch.cuda.empty_cache()
    return {"swim_churn": out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="bench_out")
    cell = ap.add_mutually_exclusive_group()
    cell.add_argument("--swim", action="store_true",
                      help="profile the cell with SWIM on (config 0 exactly)")
    cell.add_argument("--config3", action="store_true",
                      help="profile config 3 at 1000 nodes (its first 128 "
                           "rounds)")
    cell.add_argument("--config6", action="store_true",
                      help="profile config 6 at 10 000 nodes (its first "
                           "128 rounds)")
    cell.add_argument("--soak", metavar="SPEC",
                      help="profile config 0 at 10 000 nodes under the "
                           "fault scenario SPEC (its first 64 rounds)")
    cell.add_argument("--latency", action="store_true",
                      help="profile config 0 at 10 000 nodes across four "
                           "latency regions with RTT rings and 8 probes")
    cell.add_argument("--config8", action="store_true",
                      help="config 8 exactly: its 32 lanes in lockstep, "
                           "then compacted at width 16, pipelined")
    cell.add_argument("--host-read", type=int, metavar="PAIRS",
                      help="the early read of the sweep gate against the "
                           "late read, PAIRS pairs on configs 0 and 6 at "
                           "10 000 nodes")
    cell.add_argument("--swim-churn", action="store_true",
                      help="config 0's churn soak at 1024, 2048 and 4096 "
                           "nodes through `soak --serial` and run_soak, "
                           "held to SWIM_CHURN_PINS")
    args = ap.parse_args(argv)
    if args.swim_churn:
        report = dict(swim_churn(args.out),
                      card=torch.cuda.get_device_name(0),
                      nvidia_smi=mp.nvidia_smi())
        with open(os.path.join(args.out, "swim_churn.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report))
        return report
    if args.host_read:
        report = dict(host_read(args.host_read),
                      card=torch.cuda.get_device_name(0),
                      nvidia_smi=mp.nvidia_smi())
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "host_read.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report))
        return report
    if args.config8:
        report = dict(config8(), card=torch.cuda.get_device_name(0),
                      nvidia_smi=mp.nvidia_smi())
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "config8.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "frontier"}))
        return report
    device = torch.device("cuda")
    wl = None
    if args.config6:
        cfg, wl = config6_config(), config6_workload()
    elif args.config3:
        cfg = config3_config()
    elif args.soak:
        cfg = soak_config()
    elif args.latency:
        cfg = latency_config()
    else:
        cfg = slice_config(swim=args.swim)
    run = functools.partial(_run, cfg, device, wl, args.soak)

    run()  # warm-up: allocator growth, kernel build
    torch.cuda.reset_peak_memory_stats(device)
    plain = run()
    rounds = plain.rounds
    smi = mp.nvidia_smi()
    report = {
        "nodes": cfg.num_nodes, "swim": cfg.swim_enabled,
        "seqs_per_version": cfg.seqs_per_version,
        "chunks_per_version": cfg.chunks_per_version,
        "workload": None if wl is None else wl.spec,
        "scenario": args.soak,
        "repair_chunks": plain.repair_chunks,
        "card": torch.cuda.get_device_name(device),
        "nvidia_smi": smi, "rounds": rounds,
        "converged_round": plain.converged_round,
        "wall_per_round_ms": plain.wall_per_round_ms,
        "stage_ms_per_round_workload": 1e3 * plain.stage_seconds / rounds,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device),
    }

    totals, counts = defaultdict(float), defaultdict(int)
    with _stage_timers(device, totals, counts):
        timed = run()
    report["timed_wall_per_round_ms"] = timed.wall_per_round_ms
    report["stage_ms_per_round"] = {
        k: 1e3 * v / rounds for k, v in sorted(
            totals.items(), key=lambda kv: -kv[1])
    }
    report["stage_calls"] = dict(counts)
    if counts["swim_step"]:
        report["swim_tick_ms"] = 1e3 * totals["swim_step"] / counts[
            "swim_step"]

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with _swim_ranges(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = run()
        torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name != "swim_tick"]
    swim_launches, host_launches = _launches_in(events, "swim_tick")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    table = sorted(
        ({"kernel": k, "ms": v[0], "launches": v[1]}
         for k, v in by_name.items()),
        key=lambda r: -r["ms"],
    )
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = _busy_ms(spans)
    # the device-side spans of the ticks hold exactly the ticks' kernels:
    # one stream runs its kernels in launch order
    ticks = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and e.name == "swim_tick"]
    tick_busy = sum(
        _busy_ms([(max(s, a), min(e, b)) for s, e in spans
                  if s < b and e > a])
        for a, b in ticks
    )
    report.update({
        "profiled_rounds": profiled.rounds,
        "profiled_wall_ms": wall_ms,
        "kernel_launches": len(kernels),
        "kernel_launches_per_round": len(kernels) / profiled.rounds,
        "host_launch_calls": host_launches,
        "swim_tick_launch_calls": swim_launches,
        "swim_share_of_launches": (swim_launches / host_launches
                                   if host_launches else None),
        "swim_ticks_profiled": len(ticks),
        "swim_tick_device_busy_ms": (tick_busy / len(ticks)
                                     if ticks else None),
        "swim_tick_device_span_ms": (
            sum(b - a for a, b in ticks) / 1e3 / len(ticks)
            if ticks else None),
        "device_kernel_ms": sum(r["ms"] for r in table),
        "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms,
        "top_kernels": table[:15],
    })
    merge_rows = [r for r in table if "grouped_merge" in r["kernel"]]
    works = _merge_bounds(cfg, device, wl, args.soak)
    launches = sum(r["launches"] for r in merge_rows)
    def mean(f):
        return float(np.mean([f(w) for w in works]))

    report["merge_kernel"] = {
        "launches": launches,
        "ms_per_launch": (sum(r["ms"] for r in merge_rows) / launches
                          if launches else None),
        "bound_ms_per_launch": mean(lambda w: mk.bound_ms(w["in_place"])[0]),
        "bound_out_of_place_ms_per_launch": mean(
            lambda w: mk.bound_ms(w["out_of_place"])[0]),
        "bytes_per_launch": mean(lambda w: w["in_place"][0]),
        "sector_bound_ms_per_launch": mean(
            lambda w: 1e3 * w["sector_bytes"] / mk.HBM_BYTES_PER_S),
        "valid_lanes_per_launch": mean(lambda w: w["valid_lanes"]),
        "nodes_with_lanes_per_launch": mean(lambda w: w["nodes_with_lanes"]),
        "rows_hit_per_launch": mean(lambda w: w["rows_hit"]),
        "rows_wiped_per_launch": mean(lambda w: w["rows_wiped"]),
        "bounded_launches": len(works),
    }
    os.makedirs(args.out, exist_ok=True)
    soak_name = "".join(ch if ch.isalnum() else "_" for ch in args.soak or "")
    name = ("profile_slice_config6.json" if args.config6
            else "profile_slice_config3.json" if args.config3
            else f"profile_slice_soak_{soak_name}.json" if args.soak
            else "profile_slice_latency.json" if args.latency
            else "profile_slice_swim.json" if args.swim
            else "profile_slice.json")
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(dict(report, kernels=table), f, indent=1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
