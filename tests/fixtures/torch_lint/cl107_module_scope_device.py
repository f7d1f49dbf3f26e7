"""CL107 fixture: a CUDA tensor made at import time (fires once)."""
import torch

BIAS = torch.zeros(4, device="cuda")  # BAD: runs on import


def add(x):
    return x + BIAS
