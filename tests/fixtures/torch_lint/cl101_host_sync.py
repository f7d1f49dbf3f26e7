"""CL101 fixture: a host read of a tensor on the step path (fires once).

The step path arms through a function-local ``torch.compile(step)``
call.
"""
import torch


def step(x: torch.Tensor):
    total = torch.sum(x)
    scale = float(total)  # BAD: a blocking device->host read per call
    return x * scale


def run(x):
    return torch.compile(step)(x)
