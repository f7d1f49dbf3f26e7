"""CL104 fixture: Python control flow on a tensor on the step path
(fires once)."""
import torch


def step(x: torch.Tensor):
    if x.sum() > 0:  # BAD: a host sync to take the branch
        return x
    return -x


def run(x):
    return torch.compile(step)(x)
