"""Production workload engine: traffic generators and the shared
changeset injection (:mod:`corro_sim_torch.workload.inject`)."""

from corro_sim_torch.workload.generators import (
    WORKLOADS,
    Workload,
    empty_slice,
    empty_workload,
    make_workload,
    parse_workload_spec,
)

__all__ = [
    "WORKLOADS",
    "Workload",
    "assert_workload_vacuous",
    "empty_slice",
    "empty_workload",
    "make_workload",
    "parse_workload_spec",
]


def _step_loop(cfg, rounds: int, write_rounds: int, seed: int, device,
               workload=None):
    """``rounds`` plain steps of ``sim_step`` from ``init_state(cfg, 0)``
    under key ``fold_in(PRNGKey(seed), r)``, everyone alive and in one
    partition — the JAX package's ``analysis/jaxpr_audit.run_step_loop``.
    ``workload`` feeds the ``writes=`` port. Returns the final state's
    leaves and the metrics, both on the host."""
    import torch

    from corro_sim_torch import prng
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.engine.driver import metrics_to_numpy, round_key
    from corro_sim_torch.engine.state import init_state
    from corro_sim_torch.engine.step import sim_step

    n = cfg.num_nodes
    state = init_state(cfg, seed=0, device=device)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    part = torch.zeros((n,), dtype=torch.int32, device=device)
    root = prng.PRNGKey(seed)
    per_round = []
    for r in range(rounds):
        writes = None
        if workload is not None:
            writes = tuple(
                torch.tensor(x, device=device)
                for x in workload.writes_at(r, cfg.seqs_per_version)
            )
        state, m = sim_step(cfg, state, round_key(root, r), alive, part,
                            r < write_rounds, r, writes=writes)
        per_round.append(m)
    return state_to_numpy(state), metrics_to_numpy(per_round)


def assert_workload_vacuous(cfg=None, rounds: int = 10,
                            device=None) -> None:
    """The workload engine's vacuity claim (``corro-sim-torch load
    --verify-vacuous``, tests), the JAX package's
    ``assert_feature_vacuous(on_workload=)`` in two halves:

    - trace level — the write-schedule step is a DISTINCT program: its
      fx graph differs in node count from the sampler's
      (``analysis/fx_audit.py::extra_eqns``, traced on the CPU); the
      fx golden pins the workload-off program (``audit``);
    - runtime level — ``sim_step`` fed an all-idle schedule through its
      ``writes=`` port is bit-identical, on every state leaf and every
      metric of every round, to the sampler with writes disabled.
      ``device``: where both runs happen (default ``cuda``)."""
    import numpy as np

    from corro_sim_torch.analysis.fx_audit import extra_eqns
    from corro_sim_torch.device import resolve_device

    if cfg is None:
        from corro_sim_torch.config import SimConfig

        # the JAX package's default shape for this check
        cfg = SimConfig(
            num_nodes=12, num_rows=16, num_cols=2, log_capacity=128,
            write_rate=0.6,
        ).validate()
    dev = resolve_device(device)
    # raised, not asserted: the check must hold under ``python -O`` too
    if extra_eqns(cfg, cfg, workload_other=True) == 0:
        raise AssertionError(
            "workload program traces identical to the sampler program — "
            "the writes port is not a distinct program")
    s0, m0 = _step_loop(cfg, rounds, 0, 3, dev)
    s1, m1 = _step_loop(cfg, rounds, 0, 3, dev,
                        workload=empty_workload(cfg.num_nodes, rounds))
    if s0.keys() != s1.keys():
        raise AssertionError("the two runs' states have different leaves")
    for k in s0:
        if not np.array_equal(s0[k], s1[k]):
            raise AssertionError(f"state leaf {k} differs")
    if set(m1) != set(m0):
        raise AssertionError("workload metrics are not the sampler's")
    for k in m0:
        bad = np.flatnonzero(m0[k] != m1[k])
        if bad.size:
            raise AssertionError(f"metric {k} differs at round {bad[0]}")
