"""CL108 fixture: a draw from the global generator (fires once)."""
import torch


def shuffle(n):
    return torch.randperm(n)  # BAD: no generator=
