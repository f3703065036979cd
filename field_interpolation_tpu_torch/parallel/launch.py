"""Start the ranks of a sharded run from one process, and join them.

``run_ranks(fn, world, *args, device=...)`` spawns ``world`` processes, sets
up the default process group in each and calls ``fn(*args, device=...)`` on
every rank; it returns each rank's result, in rank order. ``fn`` must be
importable from its module by the spawned processes (a module that imports
no JAX: the ranks import only the port).

* Device: rank r runs on ``cuda:(r % device_count)`` unless the caller asks
  for the CPU.
* Backend: ``nccl`` when every rank has a card of its own, ``gloo``
  otherwise (ranks sharing one card, or the CPU). Under gloo the halos go
  through host memory.
* Setup: a rendezvous file in a temporary directory (no port to clash) and a
  finite timeout, so a rank that stops answering fails the run.
* Failures: if any rank raises, the others are killed and the parent raises.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..rows import resolve_device

# A rank that stops answering fails the run after this long.
TIMEOUT = datetime.timedelta(seconds=600)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(rank, fn, world, args, device_kind, rendezvous, out_dir):
    if device_kind == "cuda":
        n = torch.cuda.device_count()
        device = torch.device("cuda", rank % n)
        torch.cuda.set_device(device)
        backend = "nccl" if n >= world else "gloo"
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)  # the ranks share the host's cores
        backend = "gloo"
    dist.init_process_group(backend, init_method=rendezvous, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = fn(*args, device=device)
        torch.save(_to_cpu(out), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device: str = "cuda") -> list:
    """Run ``fn(*args, device=...)`` on ``world`` ranks; returns their
    results (tensors moved to the CPU), in rank order."""
    # The kernels are built once, here: the ranks only load the library.
    kind = resolve_device(device, build=True).type
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_rank_main, args=(fn, world, args, kind, rendezvous, tmp),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
