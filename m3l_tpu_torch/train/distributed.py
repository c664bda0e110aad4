"""Multi-process / SLURM distributed initialization (counterpart of
``m3l_tpu/train/distributed.py``; reference tactile_ssl/utils/__init__.py:12-22 SLURM rank
discovery, trainer.py:101-108).

Rank and world size come from SLURM, OpenMPI or torchrun variables. :func:`initialize_distributed`
starts a ``torch.distributed`` process group when the world size is above 1, on the backend of
``train/mesh.py``'s rule (nccl when every rank of this host has a card of its own, gloo when ranks
share a card or run on the CPU), and is a no-op returning False otherwise. Multi-device training
itself is ``train/mesh.py`` (``make_mesh`` over the group, ``launch`` to start one).
Preemption requeue is the Trainer's SIGTERM / SIGUSR1 save plus :func:`slurm_requeue`.
"""
from __future__ import annotations

import os
import subprocess


def get_local_rank() -> int:
    """SLURM/OMPI-aware rank discovery (reference utils/__init__.py:12-22)."""
    for var in ("SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "RANK"):
        if var in os.environ:
            return int(os.environ[var])
    return 0


def get_world_size() -> int:
    for var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE"):
        if var in os.environ:
            return int(os.environ[var])
    return 1


def initialize_distributed(coordinator_address: str | None = None, device: str = "cuda") -> bool:
    """Join a ``torch.distributed`` process group of :func:`get_world_size` processes as rank
    :func:`get_local_rank`, on the mesh's backend rule (``train/mesh.py`` ``backend_for``); the
    rendezvous is ``coordinator_address`` (``host:port``) or, without it, torch's ``env://``
    (MASTER_ADDR, MASTER_PORT). Returns True if a group was started, False (nothing done) for one
    process."""
    import torch.distributed as dist

    from .mesh import backend_for

    world = get_world_size()
    if world <= 1:
        return False
    if device not in ("cuda", "cpu"):
        raise ValueError(f"initialize_distributed: device {device!r} is neither cuda nor cpu")
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend_for(world, device), init_method=init_method, world_size=world, rank=get_local_rank())
    return True


def is_main_process() -> bool:
    return get_local_rank() == 0


def slurm_requeue() -> bool:
    """Requeue the current SLURM job (reference signal_connector.py:76-100). Call after the
    Trainer's preemption checkpoint save."""
    job_id = os.environ.get("SLURM_JOB_ID")
    if not job_id:
        return False
    try:
        subprocess.run(["scontrol", "requeue", job_id], check=True)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
