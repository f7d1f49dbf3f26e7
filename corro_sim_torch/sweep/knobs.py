"""The sweep knob leaf: per-lane fault and SimConfig parameters as state.

Port of ``corro_sim/sweep/knobs.py``. A serial run reads every fault
parameter from its config; a fleet sweep runs each lane under the plan's
union config, and what varies between lanes rides the ``sweep_knobs``
feature leaf (``engine/features.py``), keyed by the union
:class:`~corro_sim_torch.config.SweepConfig`'s gates:

========================  =========================================
gate                      knobs
========================  =========================================
``link_faults``           ``loss``/``dup``/``burst_enter``/
                          ``burst_exit``/``burst_loss``/``sync_loss``
                          — () float32 thresholds
``wipes`` or ``stale``    ``wipe_round`` (N,) int32 (-1 = never),
                          ``wipe_stale`` (N,) bool, ``epoch_jump`` ()
``stale``                 ``snap_round`` (N,) int32 (-1 = never)
``skew``                  ``skew`` (N,) int32 HLC offsets
``straggle``              ``straggle_period``/``straggle_active``
                          (N,) int32 duty cycles (1/1 = full duty)
``workload``              ``use_workload`` () bool
``sim_knobs``             ``write_rate``/``delete_rate`` () float32,
                          ``sync_interval``/``swim_suspect_rounds``
                          () int32 (``zipf_alpha`` has no knob: it
                          only shapes the lane's ``row_cdf`` plane)
========================  =========================================

Off the sweep the leaf is absent. The neutral values (a lane that does
not use a dimension) leave the step value-identical to a config without
that fault. The step reads the device leaf where it computes on the card
and the lane's host copy where it decides on the host
(``engine/step.py::host_knobs``).
"""

from __future__ import annotations

import numpy as np
import torch

from corro_sim_torch.engine.features import FeatureLeaf, register_feature

__all__ = [
    "SIM_KNOB_FIELDS", "SIM_KNOB_LEAF_FIELDS", "SWEEP_KNOB_FIELDS",
    "lane_knobs", "neutral_knobs",
]

# the link-fault scalar thresholds a `knob.<field>=...` grid axis may
# sweep (every other FaultConfig field changes the program's structure)
SWEEP_KNOB_FIELDS = (
    "loss", "dup", "burst_enter", "burst_exit", "burst_loss", "sync_loss",
)

# SimConfig scalars a grid axis may sweep per lane: the leaf fields ride
# sweep_knobs (the sim_knobs gate); zipf_alpha swaps the row_cdf plane
SIM_KNOB_LEAF_FIELDS = (
    "write_rate", "delete_rate", "sync_interval", "swim_suspect_rounds",
)
SIM_KNOB_FIELDS = SIM_KNOB_LEAF_FIELDS + ("zipf_alpha",)


def _host_neutral(cfg) -> dict:
    sw = cfg.sweep
    n = cfg.num_nodes
    out: dict = {}
    if sw.link_faults:
        out.update(
            loss=np.float32(0.0), dup=np.float32(0.0),
            burst_enter=np.float32(0.0), burst_exit=np.float32(1.0),
            burst_loss=np.float32(0.0), sync_loss=np.float32(0.0),
        )
    if sw.wipe_planes:
        out["wipe_round"] = np.full((n,), -1, np.int32)
        out["wipe_stale"] = np.zeros((n,), bool)
        out["epoch_jump"] = np.int32(0)
    if sw.stale:
        out["snap_round"] = np.full((n,), -1, np.int32)
    if sw.skew:
        out["skew"] = np.zeros((n,), np.int32)
    if sw.straggle:
        out["straggle_period"] = np.ones((n,), np.int32)
        out["straggle_active"] = np.ones((n,), np.int32)
    if sw.workload:
        out["use_workload"] = np.asarray(False)
    if sw.sim_knobs:
        out["write_rate"] = np.float32(cfg.write_rate)
        out["delete_rate"] = np.float32(cfg.delete_rate)
        out["sync_interval"] = np.int32(cfg.sync_interval)
        out["swim_suspect_rounds"] = np.int32(cfg.swim_suspect_rounds)
    return out


def knob_tensors(knobs: dict, device) -> dict:
    """A knob dict of host values as the leaf's tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in knobs.items()}


def neutral_knobs(cfg, seed: int = 0, device="cpu") -> dict:
    """The value-neutral leaf for ``cfg``'s armed sweep dimensions, on
    ``device``: the feature's build function (the sweep engine swaps in
    each lane's own values)."""
    return knob_tensors(_host_neutral(cfg), device)


register_feature(FeatureLeaf(
    name="sweep_knobs",
    enabled=lambda cfg: cfg.sweep.enabled,
    build=neutral_knobs,
    volatile=True,
))


def lane_knobs(union_cfg, lane_cfg, use_workload: bool = False) -> dict:
    """One lane's knob values (host numpy, the union leaf's key set)
    from the lane's serial-twin config.

    Raises ValueError for schedules the planes cannot carry (a node with
    more than one wipe, or both crashing and rejoining stale): such
    lanes run serially."""
    sw = union_cfg.sweep
    nf = lane_cfg.node_faults
    n = union_cfg.num_nodes
    out: dict = {}
    if sw.link_faults:
        f = lane_cfg.faults
        out.update(
            loss=np.float32(f.loss), dup=np.float32(f.dup),
            burst_enter=np.float32(f.burst_enter),
            burst_exit=np.float32(f.burst_exit),
            burst_loss=np.float32(f.burst_loss),
            sync_loss=np.float32(f.resolved_sync_loss),
        )
    if sw.wipe_planes:
        wipe_round = np.full((n,), -1, np.int32)
        wipe_stale = np.zeros((n,), bool)
        snap_round = np.full((n,), -1, np.int32)
        for node, r in nf.crash:
            node = int(node)
            if wipe_round[node] >= 0:
                raise ValueError(
                    f"node {node} carries more than one scheduled wipe — "
                    "the sweep's one-wipe-per-node planes cannot encode "
                    "it; run this lane serially (soak --serial)"
                )
            wipe_round[node] = int(r)
        for node, s, r in nf.stale:
            node = int(node)
            if wipe_round[node] >= 0:
                raise ValueError(
                    f"node {node} carries more than one scheduled wipe — "
                    "the sweep's one-wipe-per-node planes cannot encode "
                    "it; run this lane serially (soak --serial)"
                )
            wipe_round[node] = int(r)
            wipe_stale[node] = True
            snap_round[node] = int(s)
        out["wipe_round"] = wipe_round
        out["wipe_stale"] = wipe_stale
        out["epoch_jump"] = np.int32(nf.epoch_jump)
        if sw.stale:
            out["snap_round"] = snap_round
    if sw.skew:
        skew = np.zeros((n,), np.int32)
        for node, off in nf.skew:
            skew[int(node)] = int(off)
        out["skew"] = skew
    if sw.straggle:
        period = np.ones((n,), np.int32)
        active = np.ones((n,), np.int32)
        for node, p, a in nf.straggle:
            period[int(node)] = int(p)
            active[int(node)] = int(a)
        out["straggle_period"] = period
        out["straggle_active"] = active
    if sw.workload:
        out["use_workload"] = np.asarray(bool(use_workload))
    if sw.sim_knobs:
        out["write_rate"] = np.float32(lane_cfg.write_rate)
        out["delete_rate"] = np.float32(lane_cfg.delete_rate)
        out["sync_interval"] = np.int32(lane_cfg.sync_interval)
        out["swim_suspect_rounds"] = np.int32(lane_cfg.swim_suspect_rounds)
    return out
