"""What a multi-process run needs beyond the learner's collectives
(rainbow_tpu/parallel/multihost.py): the chief's evaluation results
broadcast to every rank, and a check that replicated tensors agree across
ranks bit for bit.

The JAX package's ``make_global_mesh``, ``globalize``,
``globalize_replay``, ``globalize_agent``, ``local_rows``,
``local_value`` and ``local_params`` have no counterpart: they turn
process-local arrays into global jax Arrays over a mesh that spans every
process, and back, so that one SPMD program runs unchanged. Here each rank
keeps plain local tensors (its agent replica, its replay shard, its env
rows) and meets the others only in the learner's all-reduces, so there is
nothing to globalize. Only ``broadcast`` and ``all_reduce`` are used: the
two collectives gloo carries for CUDA tensors.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from rainbow_tpu_torch.parallel.mesh import world


def broadcast_floats(values: Sequence[float], n: int, device) -> List[float]:
    """Rank 0's ``n`` floats on every rank: rank 0 passes its values, the
    others anything (they are ignored). Carried as float64 on ``device``, so
    every rank gets rank 0's values exactly."""
    rank, _ = world()
    buf = torch.zeros(n, dtype=torch.float64, device=device)
    if rank == 0:
        buf.copy_(torch.as_tensor(list(values), dtype=torch.float64))
    dist.broadcast(buf, src=0)
    return buf.tolist()


def tensors_agree(tensors: dict) -> bool:
    """Whether every rank holds the same bits in each of ``tensors`` (same
    keys, shapes and dtypes on every rank): rank 0's bytes are broadcast,
    compared on each rank, and the mismatch flags reduced with a max. True
    without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return True
    bits = torch.cat([v.detach().contiguous().reshape(-1).view(torch.uint8)
                      for v in tensors.values()])
    chief = bits.clone()
    dist.broadcast(chief, src=0)
    differ = (chief != bits).any().to(torch.float32).reshape(1)
    dist.all_reduce(differ, op=dist.ReduceOp.MAX)
    return not bool(differ.item())


def agent_tensors(agent) -> dict:
    """An agent's replicated tensors: params, target params, the Adam
    moments and count, for tensors_agree."""
    opt = agent.opt_state
    out = {"count": opt.count}
    for name, tree in (("params", agent.params),
                       ("target", agent.target_params), ("mu", opt.mu),
                       ("nu", opt.nu)):
        out.update({f"{name}/{k}": v for k, v in tree.items()})
    return out
