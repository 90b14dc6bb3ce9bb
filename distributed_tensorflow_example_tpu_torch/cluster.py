"""Process-group bootstrap for the trainer (the JAX package's
``cluster.py`` on ``torch.distributed``).

The reference's ``ClusterSpec`` of ps and worker tasks becomes one
process group with no roles: every process is a worker, rank 0 is the
chief.  ``--coordinator_address host:port`` is rank 0's TCP rendezvous,
``--task_index`` the rank and ``--num_processes`` the world size;
``--job_name=ps`` is accepted and explained away.  NCCL carries the
collectives between cards, gloo between CPU processes.

A process group is set up whenever a coordinator address is given, at
any world size, one included, and the data-parallel strategies run
their collectives whenever a group exists (``collectives``): a
one-rank NCCL group on one card runs the same all-reduce, all-gather
and reduce-scatter as N ranks, each over one rank.  Rank r plays
device r of the JAX package's one-process ``('data', 'model')`` mesh
(``parallel/mesh.py``), whose sub-groups carry the collectives of each
axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .config import Config
from .device import resolve_device

# printed by ``main`` when --compilation_cache is given: the JAX
# trainer's persistent XLA cache directory has nothing to configure here
COMPILATION_CACHE_NOTE = (
    "NOTE: --compilation_cache is a no-op in the PyTorch port: it "
    "compiles nothing at run time (its CUDA kernels are built once into "
    "build/kernels/), and XLA's persistent compile cache has no "
    "counterpart.")


def bootstrap(cfg: Config) -> bool:
    """Join the process group the flags describe (nothing to do without
    a coordinator address, or when the caller already set one up).
    Returns whether this call set the group up: then its caller closes
    it (``shutdown``); a group set up before is its owner's to close."""
    if cfg.job_name == "ps":
        print(
            "NOTE: --job_name=ps maps to a no-op under SPMD: parameters are "
            "device-resident and gradient exchange is a compiled psum "
            "allreduce, so there is no parameter-server role. This process "
            "will participate as a regular worker."
        )
    if cfg.coordinator_address and not dist.is_initialized():
        dev = resolve_device(cfg.device)
        if dev.type == "cuda":
            torch.cuda.set_device(cfg.task_index % torch.cuda.device_count())
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{cfg.coordinator_address}",
            world_size=cfg.num_processes, rank=cfg.task_index)
        return True
    return False


def collectives() -> bool:
    """Whether a process group exists, so the strategies' collectives
    run (at any world size, one included)."""
    return dist.is_initialized()


def all_gather_flat(out: torch.Tensor, inp: torch.Tensor,
                    group=None) -> None:
    """``out`` [size * n] <- every member's ``inp`` [n], in group rank
    order (``group``: a sub-group, default the world; through
    ``all_gather_single`` where torch has it, else its older name
    ``all_gather_into_tensor``, which newer torch deprecates)."""
    fn = (getattr(dist, "all_gather_single", None)
          or dist.all_gather_into_tensor)
    fn(out, inp, group=group)


def reduce_scatter_flat(out: torch.Tensor, inp: torch.Tensor,
                        group=None) -> None:
    """``out`` [n] <- this member's block of the sum over the group of
    ``inp`` [size * n] (``reduce_scatter_single`` where torch has it,
    else ``reduce_scatter_tensor``)."""
    fn = (getattr(dist, "reduce_scatter_single", None)
          or dist.reduce_scatter_tensor)
    fn(out, inp, group=group)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    """Rank 0 (the reference's ``Supervisor(is_chief=...)``)."""
    return process_index() == 0


def shutdown() -> None:
    """Leave the process group (the reference's ``sv.stop()``)."""
    if dist.is_initialized():
        dist.destroy_process_group()
