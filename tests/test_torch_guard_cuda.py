"""The transfer guard on the card: ``torch.cuda.set_sync_debug_mode``.

Every test is marked ``cuda`` and skips without a CUDA device: on the
CPU the guard is a dispatch mode, tested in tests/test_torch_analysis.py.
The file imports no JAX:

    python -m pytest tests/test_torch_guard_cuda.py -q -m cuda

An unsanctioned host read of a CUDA tensor inside a guarded region
raises; a sanctioned one passes and counts; a guarded run of the step on
the card equals the unguarded run bit for bit (tolerance: exact).
"""

import numpy as np
import pytest
import torch

from corro_sim_torch.analysis import transfer_guard as tg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sync debug mode is CUDA's)")
    return torch.device("cuda")


@pytest.mark.parametrize("read", ["item", "bool", "nonzero", "to_cpu"])
def test_guard_refuses_a_host_read_on_the_card(read, dev):
    x = torch.arange(8, device=dev)
    reads = {"item": lambda: x.sum().item(),
             "bool": lambda: bool((x > 3).any()),
             "nonzero": lambda: torch.nonzero(x),
             "to_cpu": lambda: x.cpu()}
    with tg.guarded(True, dev) as armed:
        assert armed
        assert torch.cuda.get_sync_debug_mode() == 2
        with pytest.raises(RuntimeError, match="synchroniz"):
            reads[read]()
        with tg.sanctioned("card_test"):
            assert torch.cuda.get_sync_debug_mode() == 0
            reads[read]()
        assert torch.cuda.get_sync_debug_mode() == 2
    assert torch.cuda.get_sync_debug_mode() == 0


def test_guarded_run_on_the_card_is_bit_identical(dev):
    from corro_sim_torch.config import SimConfig
    from corro_sim_torch.convert import state_to_numpy
    from corro_sim_torch.engine.driver import Schedule, run_sim
    from corro_sim_torch.engine.state import init_state

    cfg = SimConfig(num_nodes=16, num_rows=16, num_cols=2, log_capacity=64,
                    write_rate=0.5, swim_enabled=True, sync_interval=4)
    runs = {}
    for guard in (True, False):
        runs[guard] = run_sim(cfg, init_state(cfg, seed=0, device=dev),
                              Schedule(write_rounds=4), max_rounds=48,
                              chunk=8, seed=0, device=dev,
                              transfer_guard=guard)
    a, b = state_to_numpy(runs[True].state), state_to_numpy(
        runs[False].state)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert runs[True].converged_round == runs[False].converged_round
    assert runs[True].transfer_guard["metric_resolve"] >= 1
