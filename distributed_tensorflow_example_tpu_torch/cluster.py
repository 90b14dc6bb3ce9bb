"""Process-group bootstrap for the trainer (the JAX package's
``cluster.py`` on ``torch.distributed``).

The reference's ``ClusterSpec`` of ps and worker tasks becomes one
process group with no roles: every process is a worker, rank 0 is the
chief.  ``--coordinator_address host:port`` is rank 0's TCP rendezvous,
``--task_index`` the rank and ``--num_processes`` the world size;
``--job_name=ps`` is accepted and explained away.  NCCL carries the
collectives between cards, gloo between CPU processes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .config import Config
from .device import resolve_device


def bootstrap(cfg: Config) -> None:
    """Join the process group the flags describe (nothing to do for one
    process)."""
    if cfg.job_name == "ps":
        print(
            "NOTE: --job_name=ps maps to a no-op under SPMD: parameters are "
            "device-resident and gradient exchange is a compiled psum "
            "allreduce, so there is no parameter-server role. This process "
            "will participate as a regular worker."
        )
    if cfg.coordinator_address and cfg.num_processes > 1:
        dev = resolve_device(cfg.device)
        if dev.type == "cuda":
            torch.cuda.set_device(cfg.task_index % torch.cuda.device_count())
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{cfg.coordinator_address}",
            world_size=cfg.num_processes, rank=cfg.task_index)


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
