"""Host-runtime helpers of the run loop: the atomic JSON dump, the
asynchronous device-to-host fetch, the non-blocking upload and the host
copy of a state leaf.

``atomic_json_dump`` is ``corro_sim/utils/runtime.py``'s. The JAX
package's ``start_async_fetch`` starts ``copy_to_host_async`` on each
buffer; here :func:`start_async_fetch` enqueues a copy of each tensor
into pinned host memory with ``non_blocking=True`` and records a CUDA
event behind it, and :meth:`AsyncFetch.resolve` waits on that event
alone (the host never waits for work queued after the copy). On the CPU
it is a plain copy.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def atomic_json_dump(path: str, obj, indent: int | None = None) -> bool:
    """Write-then-rename JSON dump, so readers never see a torn file.
    Never raises: returns False on OSError (an artifact write must not
    kill the run it documents)."""
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent)
        os.replace(tmp, path)
        return True
    except OSError:
        return False


class AsyncFetch:
    """Device-to-host copies in flight; :meth:`resolve` returns them as
    numpy arrays."""

    def __init__(self, tensors):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self._host = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors
            ]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.detach().clone() for t in tensors]

    def ready(self) -> bool:
        """Whether the copies have landed (never waits)."""
        return self._event is None or self._event.query()

    def resolve(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def start_async_fetch(*tensors) -> AsyncFetch:
    """Begin copying ``tensors`` to the host without blocking."""
    return AsyncFetch(tensors)


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, without waiting for the card: through
    pinned memory with ``non_blocking`` (a pageable copy would first
    drain the card's queue)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def host_array(x) -> np.ndarray:
    """A state leaf as a numpy array: a tensor on any device is copied to
    the host, anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
