"""Process-group start-up (counterpart of
`faithdiff_tpu/parallel/distributed.py`, where `jax.distributed.initialize`
joins the hosts of a pod slice).

Here every process drives one card and `torch.distributed` joins them:
NCCL on the card, gloo when the caller asks for the CPU. Under torchrun
the rendezvous comes from its environment (`MASTER_ADDR`, `MASTER_PORT`,
`WORLD_SIZE`, `RANK`, `LOCAL_RANK`); explicit arguments take its place, as
the JAX function's mirror the reference's accelerate fields.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda") -> int:
    """Join the process group and return this process's rank; a no-op
    (rank 0) in one process with no coordinator, as in JAX: the group starts
    when a coordinator is given (`coordinator_address`, "host:port" or
    "tcp://host:port", else torchrun's `MASTER_ADDR` / `MASTER_PORT`) or
    more than one process is asked for. `num_processes` and `process_id`
    default to `WORLD_SIZE` and `RANK`. On the card each process takes the
    card of its `LOCAL_RANK` (else its rank modulo the cards) and NCCL;
    `device="cpu"` takes gloo. A group already started is kept."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    address = coordinator_address
    if address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    n = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    if address is None and n <= 1:
        return 0
    if address is None:
        raise ValueError(f"{n} processes need a coordinator address "
                         "(coordinator_address, or MASTER_ADDR and MASTER_PORT)")
    if "://" not in address:
        address = "tcp://" + address
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group("nccl" if on_card else "gloo", init_method=address,
                            world_size=n, rank=rank)
    return rank


def world() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch this process feeds: an equal share each,
    in rank order (JAX's per-host slice for
    `jax.make_array_from_process_local_data`)."""
    per = global_batch // world()
    i = rank()
    return slice(i * per, (i + 1) * per)
