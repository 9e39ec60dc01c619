"""Data parallelism over processes (the counterpart of
aot_tpu/parallel/mesh.py and aot_tpu/train/step.py:128 shard_train_step;
reference: tools/train.py's mp.spawn and networks/managers/trainer.py's
DDP).

One process a rank, one rank a device: NCCL on the cards (rank r on
cuda:{DIST_START_GPU + r}), gloo on the CPU. Every rank holds the whole
model and optimizer state and 1/W of the global batch; the train step
averages the gradients across the ranks before the global-norm clip, so
the update is the one of the global batch on every rank
(train/step.py). `launch` starts the ranks (torch.multiprocessing.spawn;
one rank runs in the calling process), initialises the process group in
each and calls `fn(device, *args)`.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

# gradients are averaged in flat buckets of this many fp32 elements
# (256 MB), one all_reduce each
BUCKET_NUMEL = 1 << 26


def is_live() -> bool:
    """True when a process group is initialised in this process."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_live() else 0


def world_size() -> int:
    return dist.get_world_size() if is_live() else 1


def dp_world_size(cfg, device_type: str) -> int:
    """The number of ranks MESH_DP_SIZE asks for: itself when positive,
    else every visible card from DIST_START_GPU on (one on the CPU), as
    aot_tpu's make_mesh(-1) takes every device."""
    n = int(cfg.MESH_DP_SIZE)
    if n > 0:
        return n
    if device_type != "cuda":
        return 1
    return max(torch.cuda.device_count() - int(cfg.DIST_START_GPU), 1)


def local_batch(global_batch: int, world: int) -> int:
    """A rank's share of TRAIN_BATCH_SIZE (aot_tpu/train/trainer.py:40-43
    raises the same way)."""
    if global_batch % world != 0:
        raise ValueError(f"batch {global_batch} not divisible by {world} "
                         "ranks")
    return global_batch // world


def rank_devices(world: int, device_type: str = "cuda",
                 start_gpu: int = 0) -> List[str]:
    """One device a rank: cuda:{start_gpu + r}, or the CPU for every rank.
    Raises when the machine has fewer cards than ranks; never falls back
    to the CPU."""
    if device_type == "cpu":
        return ["cpu"] * world
    if device_type != "cuda":
        raise ValueError(f"data parallelism runs on cuda or cpu, not "
                         f"{device_type!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if start_gpu + world > have:
        first = max(have, start_gpu)
        raise RuntimeError(
            f"no CUDA device cuda:{first} for rank {first - start_gpu}: "
            f"{world} rank(s) from cuda:{start_gpu} need {start_gpu + world} "
            f"cards, torch sees {have}; pass --device cpu to run the ranks "
            "on the CPU (gloo)")
    return [f"cuda:{start_gpu + r}" for r in range(world)]


def _run_rank(r: int, fn: Callable, world: int, devices: Sequence[str],
              backend: str, init_method: str, args: tuple) -> None:
    device = torch.device(devices[r])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif world > 1 and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method, rank=r,
                            world_size=world)
    try:
        fn(device, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: tuple = (), *,
           devices: Optional[Sequence[str]] = None,
           init_method: Optional[str] = None) -> None:
    """Run fn(device, *args) on `world` ranks, each in a process group of
    that size: rank 0 in this process when world == 1, else `world`
    spawned processes (fn must be importable by name there). `devices`:
    one per rank (default: rank_devices(world)); the group is NCCL when
    the ranks hold distinct cards, else gloo (the CPU, or several ranks on
    one card, which NCCL refuses). `init_method`: the rendezvous, by
    default a file in a fresh temporary directory (file:// needs no free
    port)."""
    devices = list(devices) if devices is not None else rank_devices(world)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    cards = [d for d in devices if d.startswith("cuda")]
    backend = "nccl" if len(set(cards)) == world else "gloo"
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="aot_dp_")
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    try:
        if world == 1:
            _run_rank(0, fn, 1, devices, backend, init_method, args)
        else:
            import torch.multiprocessing as mp

            mp.spawn(_run_rank, nprocs=world, join=True,
                     args=(fn, world, devices, backend, init_method, args))
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _buckets(tensors: Iterable[torch.Tensor]):
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() > BUCKET_NUMEL:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


@torch.no_grad()
def average_gradients(params: Sequence[torch.Tensor]) -> None:
    """Average the parameters' .grad across the ranks of the live group
    (SUM, then / W) in flat buckets, one all_reduce each; a missing .grad
    is zeros, as the optimizer reads it. Every rank passes the same
    parameters in the same order."""
    world = world_size()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for bucket in _buckets([p.grad for p in params]):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def mean_across_ranks(stats: Dict[str, torch.Tensor],
                      keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """`stats` with the floating entries named in `keys` replaced by their
    mean over the ranks (one all_reduce of them all), for the log."""
    keys = [k for k in keys if k in stats]
    if not is_live() or not keys:
        return stats
    flat = torch.cat([stats[k].float().reshape(-1) for k in keys])
    dist.all_reduce(flat)
    flat.div_(world_size())
    out, offset = dict(stats), 0
    for k in keys:
        n = stats[k].numel()
        out[k] = flat[offset:offset + n].view_as(stats[k])
        offset += n
    return out
