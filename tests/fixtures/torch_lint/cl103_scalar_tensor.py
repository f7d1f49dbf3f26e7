"""CL103 fixture: a tensor from a bare Python number on the step path
(fires once)."""
import torch


def step(x: torch.Tensor):
    one = torch.tensor(1)  # BAD: a blocking copy, inferred dtype
    return x + one


def run(x):
    return torch.compile(step)(x)
