"""The rank launcher: D processes of ``torch.distributed``, one per shard.

The port's counterpart of the JAX package's multi-device runtime (where
one process drives every device and XLA runs the collectives).
:func:`run_ranks` spawns D processes with ``torch.multiprocessing``,
joins them through a ``file://`` rendezvous in a temporary directory (no
network), and runs ``fn(*args, **kwargs)`` on every rank; it returns
rank 0's result. Each rank's device is ``cuda:{local rank}`` with the
``nccl`` backend where cards are asked for, else ``cpu`` with ``gloo``
and one torch thread per rank (D ranks on a shared CPU would otherwise
oversubscribe its cores).

A world already started by ``torchrun`` (``WORLD_SIZE`` in the
environment) is joined in place by :func:`init_from_env`; a one-rank
world in the calling process (the chip smoke's one-card NCCL mesh) by
:func:`init_single`.

A rank that fails or hangs fails the launch: the others are killed when
one exits with an error or when ``timeout`` seconds pass, and the
launch raises with the failing rank's traceback.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch

_DEVICE: dict = {}


def rank_device() -> torch.device:
    """This rank's device (set when the rank joined its world)."""
    return _DEVICE.get("device", torch.device("cpu"))


def _join(rank: int, world: int, init_method: str, device_kind: str):
    if device_kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        backend = "gloo"
    kw = {"device_id": dev} if backend == "nccl" else {}
    torch.distributed.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world, **kw)
    _DEVICE["device"] = dev
    return dev


def init_single(device="cuda", tmpdir: str | None = None) -> torch.device:
    """Start a one-rank world in this process (``nccl`` on a card, else
    ``gloo``), joined through a ``FileStore`` file. Raises if the
    communicator cannot be made."""
    kind = torch.device(device).type
    d = tmpdir or tempfile.mkdtemp(prefix="corro-mesh-")
    return _join(0, 1, f"file://{os.path.join(d, 'rendezvous')}", kind)


def init_from_env(device="cuda") -> torch.device:
    """Join the world ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT`` in the environment)."""
    kind = torch.device(device).type
    return _join(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                 "env://", kind)


def shutdown() -> None:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    _DEVICE.clear()


def _worker(rank, world, init_method, device_kind, fn, args, kwargs,
            outdir):
    try:
        _join(rank, world, init_method, device_kind)
        result = fn(*args, **kwargs)
        if rank == 0:
            with open(os.path.join(outdir, "result.pkl"), "wb") as f:
                pickle.dump(result, f)
        torch.distributed.barrier()
    except BaseException:
        with open(os.path.join(outdir, f"error.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        shutdown()


def run_ranks(fn, ranks: int, *args, device: str = "cpu",
              timeout: float = 600.0, **kwargs):
    """Run ``fn(*args, **kwargs)`` on ``ranks`` fresh processes joined
    as one world; return rank 0's result. ``fn`` and its arguments must
    pickle (a module-level function of the port, not of a test file: the
    children import its module). Under an existing world of ``ranks``
    ranks (``torchrun``) the call runs ``fn`` in place."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        if torch.distributed.get_world_size() != ranks:
            raise ValueError(
                f"asked for {ranks} ranks inside a world of "
                f"{torch.distributed.get_world_size()}")
        return fn(*args, **kwargs)
    kind = torch.device(device).type
    if kind == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(
            f"{ranks} NCCL ranks need {ranks} cards; "
            f"{torch.cuda.device_count()} visible")
    tmp = tempfile.mkdtemp(prefix="corro-ranks-")
    try:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = torch.multiprocessing.start_processes(
            _worker, args=(ranks, init_method, kind, fn, args, kwargs, tmp),
            nprocs=ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while True:
            try:
                if ctx.join(timeout=1.0):
                    break
            except Exception as exc:  # a rank failed: the others are
                # terminated by join; report the first traceback
                errs = sorted(f for f in os.listdir(tmp)
                              if f.startswith("error."))
                detail = ""
                if errs:
                    with open(os.path.join(tmp, errs[0])) as f:
                        detail = f.read()
                raise RuntimeError(
                    f"rank failed: {exc}\n{detail}") from None
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(5)
                raise TimeoutError(
                    f"{ranks} ranks did not finish in {timeout} s")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
