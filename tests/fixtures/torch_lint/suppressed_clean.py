"""Suppression fixture: a CL101 hazard silenced in place (zero findings).

The step path arms through a function-local ``torch.compile(step)``
call.
"""
import torch


def step(x: torch.Tensor):
    # host read sanctioned here for the fixture's sake
    scale = float(torch.sum(x))  # corro-lint: ignore[CL101]
    return x * scale


def run(x):
    return torch.compile(step)(x)
