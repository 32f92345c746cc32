"""Process-group bring-up and the local shard devices
(rainbow_tpu/parallel/mesh.py:1-41).

The JAX package puts a 1-D 'data' mesh over its devices and reduces over
it inside one SPMD program. Here a process holds a list of shard devices
(``make_mesh``), one replica of the agent and one replay shard on each,
and reduces first over its own shards, then over the processes of a
torch.distributed group (``init_distributed``). One rank per GPU is the
multi-process layout: a rank's shard device is ``cuda:{local rank}``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from rainbow_tpu_torch.device import resolve_device


def indexed(device) -> torch.device:
    """``device`` as a torch.device, a CUDA device with its index (plain
    ``cuda`` is the current one), so that two names of one card compare
    equal; raises if it names CUDA and there is none."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices: Optional[Sequence] = None,
              device="cuda") -> List[torch.device]:
    """The shard devices of this process: ``devices`` if given, else every
    local CUDA device for a CUDA ``device`` (as the JAX package's default
    is jax.devices()), else ``[device]``."""
    if devices is not None:
        out = [indexed(d) for d in devices]
        if not out:
            raise ValueError("make_mesh: needs at least one device")
        return out
    dev = indexed(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda",
                     backend: Optional[str] = None) -> None:
    """Join the process group of a multi-process run; a no-op for one
    process. ``coordinator`` is rank 0's ``host:port``. The backend follows
    the device, NCCL for CUDA and gloo for the CPU, unless ``backend`` names
    one (gloo also carries CUDA tensors, which lets two ranks share one
    card, as NCCL will not)."""
    if not num_processes or num_processes <= 1:
        return
    if not coordinator or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "host:port and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside "
                         f"0..{num_processes - 1}")
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def world() -> tuple:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
