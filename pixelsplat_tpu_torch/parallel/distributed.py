"""Process wiring: one process per GPU, joined in a `torch.distributed` group.

Port of `pixelsplat_tpu/parallel/distributed.py`. Where the JAX package
wires its processes with `jax.distributed.initialize` and then sees every
host's devices in one mesh, each process here drives one card and the
processes meet in a process group: NCCL between cards, gloo on the CPU.

`maybe_initialize` reads, in this order:
- torchrun's variables `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`
  and `MASTER_PORT` (`torchrun --nproc_per_node=N -m pixelsplat_tpu_torch.main ...`);
- the JAX package's explicit wiring `PIXELSPLAT_COORDINATOR` (`host:port`,
  or a URL such as `file:///shared/store`), `PIXELSPLAT_NUM_PROCESSES` and
  `PIXELSPLAT_PROCESS_ID`;
- its auto mode `PIXELSPLAT_DISTRIBUTED=1`, which under SLURM takes the
  rank, world size and local rank from `SLURM_PROCID`, `SLURM_NTASKS` and
  `SLURM_LOCALID`, and the coordinator from `MASTER_ADDR` (else the first
  host of `SLURM_JOB_NODELIST`) and `MASTER_PORT` (else 29500).
Without any of them a run is one process: rank 0 of 1, and no group.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Mapping, Optional, Union

import torch
import torch.distributed as dist

DEFAULT_PORT = 29500


@dataclass(frozen=True)
class Wiring:
    """Where a process stands in its group and how it joins it."""

    rank: int
    world_size: int
    local_rank: int
    init_method: str


def first_slurm_host(nodelist: str) -> str:
    """The first host of a SLURM node list: `gpu[03-05,07],cpu1` -> `gpu03`."""
    match = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist.strip())
    if match is None:
        raise ValueError(f"cannot read the SLURM node list {nodelist!r}")
    prefix, ranges = match.groups()
    if ranges is None:
        return prefix
    return prefix + re.split(r"[-,]", ranges)[0]


def _coordinator_url(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def read_wiring(env: Optional[Mapping[str, str]] = None) -> Optional[Wiring]:
    """The wiring the environment asks for, or None for one process."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        rank = int(env["RANK"])
        return Wiring(rank, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", rank)), "env://")
    coordinator = env.get("PIXELSPLAT_COORDINATOR")
    processes, process_id = env.get("PIXELSPLAT_NUM_PROCESSES"), env.get("PIXELSPLAT_PROCESS_ID")
    if coordinator and processes and process_id:
        rank = int(process_id)
        return Wiring(rank, int(processes), int(env.get("LOCAL_RANK", rank)), _coordinator_url(coordinator))
    if env.get("PIXELSPLAT_DISTRIBUTED", "") == "1":
        if "SLURM_PROCID" not in env:
            raise RuntimeError(
                "PIXELSPLAT_DISTRIBUTED=1 outside SLURM: launch with torchrun or set "
                "PIXELSPLAT_COORDINATOR, PIXELSPLAT_NUM_PROCESSES and PIXELSPLAT_PROCESS_ID"
            )
        host = env.get("MASTER_ADDR") or first_slurm_host(env.get("SLURM_JOB_NODELIST", env.get("SLURM_NODELIST", "")))
        port = env.get("MASTER_PORT", str(DEFAULT_PORT))
        return Wiring(
            int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]), int(env.get("SLURM_LOCALID", 0)),
            f"tcp://{host}:{port}",
        )
    return None


_local_rank = 0


def maybe_initialize(
    device: Union[str, torch.device] = "cuda", backend: Optional[str] = None
) -> tuple[int, int]:
    """Join the process group the environment asks for; returns (rank,
    world size).

    The backend is NCCL for a CUDA `device` and gloo for the CPU; `backend`
    overrides it (two processes sharing one card over gloo, in tests and
    `chip_smoke.py`). On CUDA the process's card is `cuda:LOCAL_RANK`
    (`local_device`). A second call, or a call in a process whose group
    already exists, reports that group.
    """
    global _local_rank
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    wiring = read_wiring()
    if wiring is None:
        return 0, 1
    device = torch.device(device)
    _local_rank = wiring.local_rank
    if device.type == "cuda":
        torch.cuda.set_device(wiring.local_rank)
    dist.init_process_group(
        backend=backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=wiring.init_method,
        rank=wiring.rank,
        world_size=wiring.world_size,
    )
    return wiring.rank, wiring.world_size


def local_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """`device` with a CUDA device's index set to this process's local rank."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", _local_rank if dist.is_initialized() else 0)
    return device


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default group, (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_rank_zero() -> bool:
    """True on the process that logs, validates and saves: every process
    computes (collectives are collective), one writes."""
    return rank_and_world()[0] == 0


def rank_seed(seed: int, rank: int) -> int:
    """A generator seed for `rank`: `seed` itself on rank 0, so a one-process
    run draws what it always drew; the other ranks far from it."""
    return seed + rank * 2**32


def destroy() -> None:
    """Leave the default group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()
