"""Process-group bring-up and process-role helpers (mirrors
aladin_tpu/parallel/distributed.py on ``torch.distributed``).

One process a GPU, started by ``torchrun``, as PyTorch runs multi-GPU work:

  * ``initialize()`` reads torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``, or takes the coordinator,
    the process count and the process id explicitly; NCCL for a CUDA
    device (each rank on ``cuda:LOCAL_RANK``), gloo for the CPU. Without a
    cluster it does nothing;
  * rank and world size come from the default process group (0 and 1
    without one);
  * ``all_reduce_metrics`` reduces host-local scalars over every rank, and
    every rank returns the same dict;
  * ``barrier`` waits for every rank; ``shutdown`` leaves the group.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

from aladin_torch.utils.logging import setup_logger

#: the collectives' time limit: a rank that never arrives fails the others
TIMEOUT = timedelta(minutes=10)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda") -> None:
    """Join the process group. Safe no-op for a single process.

    With ``num_processes`` > 1 (or a coordinator ``host:port``), the group
    is formed over ``tcp://<coordinator>`` with that size and this
    ``process_id``; otherwise it is formed from torchrun's environment
    when ``WORLD_SIZE`` is set, and not at all when it is not. ``device``
    ('cuda' or 'cpu') picks the backend: NCCL, with this rank's card set
    from ``LOCAL_RANK``, or gloo. A second call does nothing."""
    if dist.is_initialized():
        return
    explicit = (num_processes is not None and num_processes > 1) or coordinator_address
    if not explicit and "WORLD_SIZE" not in os.environ:
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)))
    backend = "nccl" if cuda else "gloo"
    if explicit:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes or 1), rank=int(process_id or 0),
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)


def shutdown() -> None:
    """Leave the process group, if this process joined one. Under NCCL the
    CUDA graphs that captured its collectives must be gone first: NCCL
    waits for them before it destroys the communicator."""
    if dist.is_initialized():
        dist.destroy_process_group()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: this
    rank's card under NCCL, the CPU under gloo or without a group."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_metrics(metrics: Dict[str, float], op: str = "mean") -> Dict[str, float]:
    """Reduce HOST-LOCAL scalar metrics over every rank: the values in
    sorted-key order as one f32 vector, summed, divided by the world size
    for ``mean``. Every rank returns the same dict."""
    assert op in ("mean", "sum"), op
    items = sorted(metrics.items())
    local = torch.tensor([float(v) for _, v in items], dtype=torch.float32)
    if get_world_size() > 1:
        buf = local.to(collective_device())
        dist.all_reduce(buf)
        local = buf.cpu() if op == "sum" else buf.cpu() / get_world_size()
    return {k: float(v) for (k, _), v in zip(items, local.tolist())}


def barrier(name: str = "barrier") -> None:
    """Block until every rank reaches this point (``name``: the reference's
    label of the point, unused by torch.distributed)."""
    if get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def rank_seed(seed: int, rank: int) -> int:
    """``seed`` with the rank folded in, for the dropout generators of a
    data-parallel run: rank 0 keeps ``seed``, and no two ranks share one."""
    return (int(seed) + int(rank) * 0x9E3779B1) % (2 ** 63)


def rank_logger(save_dir: Optional[str] = None) -> logging.Logger:
    """The "vlpretrain" logger: at INFO, with ``<save_dir>/log.txt``, on the
    main process; at WARNING and without a file on the others, so that one
    rank logs and writes."""
    if is_main_process():
        return setup_logger("vlpretrain", save_dir)
    return setup_logger("vlpretrain", None, level=logging.WARNING)
