"""The port's analysis tools: the counterparts of ``corro_sim/analysis/``.

- :mod:`~corro_sim_torch.analysis.rules` /
  :mod:`~corro_sim_torch.analysis.lint` — the AST rule engine
  (``python -m corro_sim_torch lint``): torch hazards on the step path
  (host syncs, key reuse, scalar tensors, branches on a tensor, reads of
  a consumed state, device work at import, unseeded draws and unstable
  sorts, fold-tag collisions) with per-rule
  ``# corro-lint: ignore[RULE]`` suppressions;
- :mod:`~corro_sim_torch.analysis.fx_audit` — traces ``sim_step`` to a
  ``torch.fx`` graph of aten ops under a matrix of feature-off configs
  and checks the vacuity invariants and the committed op-count golden
  (``audit``);
- :mod:`~corro_sim_torch.analysis.dataflow` /
  :mod:`~corro_sim_torch.analysis.contracts` — the program-contract
  auditor (``audit --contracts``): dataflow vacuity proofs for every
  registered feature x program, the mesh's collective budget counted on
  gloo ranks, determinism censuses and a static peak-bytes golden;
- :mod:`~corro_sim_torch.analysis.keys` — the key-lineage auditor
  (``audit --keys``), recorded at ``prng.py``'s functions;
- :mod:`~corro_sim_torch.analysis.transfer_guard` — the transfer guard
  around the driver's chunk loop (``CORRO_SIM_TRANSFER_GUARD``).

Heavy imports stay in the submodules: importing this package pulls no
torch (the lint engine is pure AST).
"""

from corro_sim_torch.analysis.rules import RULES, Finding  # noqa: F401
from corro_sim_torch.analysis.lint import (  # noqa: F401
    LintResult,
    collect_files,
    export_metrics,
    lint_paths,
    render_json,
    render_text,
)
