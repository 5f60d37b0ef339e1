"""Worlds of processes: the port's counterpart of the reference's many
devices under one controller.

The reference is single-controller: one Python process sees every
device of its mesh, and ``shard_map`` runs a function on each.  The port
is multi-controller, as PyTorch is: one process a rank, joined by a
``torch.distributed`` process group, each running the per-rank function
with explicit collectives (``distributed.collectives``).  This module
starts such a world and says where a rank runs.

  * ``init_world(backend, rank, world_size, init_method, device)`` joins
    this process to a world: a rank's device is ``cuda:{rank %
    device_count}``, or the CPU when asked (``device="cpu"``).  NCCL needs
    a card a rank, so ranks that share a card (a world larger than the
    host's card count) take ``gloo``, whose all-gather, reduce-scatter
    and all-to-all then stage CUDA tensors through the host
    (``collectives.stage_through_host``).  The group's ``timeout`` is
    minutes, not PyTorch's 30-minute default: a collective that hangs
    fails its caller instead.
  * ``spawn(fn, world_size, *args)`` starts ``world_size`` processes
    (the ``spawn`` start method), meets them at a ``file://`` rendezvous
    in a fresh temporary directory (no TCP port, so concurrent worlds
    never collide), runs ``fn(rank, *args)`` in each with one torch
    thread, and returns the results in rank order.  It joins with a
    timeout; when a rank fails or dies, or time runs out, it kills the
    others and raises with that rank's traceback.

``is_first(mesh)`` and ``barrier(mesh)`` serve code that writes from
one rank of a mesh (the checkpoints of ``train``): the mesh's first rank,
and a wait for every rank of the mesh.  Outside a world
(``torch.distributed`` not initialised) ``is_first`` is True and
``barrier`` does nothing, so such code runs unchanged in one process.
"""
from __future__ import annotations

import datetime
import faulthandler
import multiprocessing as mp
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=3)


def _device_of(rank: int, device=None) -> torch.device:
    """The device of rank ``rank``: the CPU when ``device`` says so, else
    ``cuda:{rank % device_count}`` (several ranks share a card when the
    world is larger than the host's card count)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("a rank on the card needs a CUDA card; pass "
                           "device='cpu' to run the world on the CPU")
    return torch.device("cuda", rank % n)


def init_world(backend: str, rank: int, world_size: int, init_method: str,
               device=None) -> torch.device:
    """Join this process to a world as ``rank``; returns its device."""
    dev = _device_of(rank, device)
    if backend == "nccl" and (dev.type != "cuda"
                              or world_size > torch.cuda.device_count()):
        raise ValueError(f"nccl needs a card a rank ({world_size} ranks, "
                         f"{torch.cuda.device_count()} cards, device "
                         f"{dev}); ranks that share a card take gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "gloo":
            from .collectives import stage_through_host
            stage_through_host()
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_first(mesh=None) -> bool:
    """Whether this rank is the first of ``mesh`` (its coordinate all 0),
    or of the world with no mesh; True outside a world."""
    if mesh is None:
        return rank() == 0
    coord = mesh.get_coordinate()
    return coord is not None and not any(coord)


def barrier(mesh=None) -> None:
    """Wait for every rank of the world, or of ``mesh``: a barrier over
    each of its axes in turn, which holds a rank until every rank of the
    mesh has arrived (the ranks off the mesh take no part)."""
    if not dist.is_initialized():
        return
    if mesh is None:
        dist.barrier()
        return
    for name, n in zip(mesh.mesh_dim_names, mesh.shape):
        if n > 1:
            dist.barrier(group=mesh.get_group(name))


def _rank_main(rank: int, world_size: int, init_method: str, backend: str,
               device, fn: Callable, args: tuple, results) -> None:
    faulthandler.enable()           # a rank killed by a signal: its stack
    try:
        torch.set_num_threads(1)
        init_world(backend, rank, world_size, init_method, device)
        out = fn(rank, *args)
        results.put((rank, True, out))
    except BaseException:                   # reported to the caller
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, backend: str = "gloo",
          device=None, timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``world_size`` new processes joined in a
    world; returns the ranks' results in rank order.  ``fn`` and
    ``args`` must pickle (a module-level function, numpy arrays)."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    init_method = f"file://{tmp}/rendezvous"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, init_method, backend, device,
                               fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(out))
                raise TimeoutError(f"world of {world_size}: ranks {missing} "
                                   f"gave no result within {timeout_s} s")
            try:
                r, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} of {world_size} died "
                                           f"(exit code {p.exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} of {world_size} failed:\n"
                                   f"{value}")
            out[r] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == world_size else 0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
