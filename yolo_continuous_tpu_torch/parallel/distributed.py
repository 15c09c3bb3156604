"""Multi-process runtime (counterpart of ``yolo_continuous_tpu/parallel/distributed.py``).

One process a device: ``initialize`` joins the process group (NCCL on CUDA,
gloo on the CPU), ``parallel/mesh.make_mesh`` lays the processes out as a
(data, model) mesh, and each process feeds its slice of the global batch.

    from yolo_continuous_tpu_torch.parallel import distributed as dist
    dist.initialize()                       # torchrun's environment
    mesh = make_mesh(dist.process_count())  # every process on "data"
    batch = dist.host_local_batch(mesh, local_batch)

Launched by ``torchrun --nproc_per_node N``, ``initialize()`` reads its
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``); otherwise pass the coordinator's address (``host:port``,
or an init-method URL such as ``file:///path``), the process count and this
process's index. A single process without that environment needs no group:
``initialize()`` is then a no-op, as it is when the group exists already.
The group has a finite timeout, so a lost peer fails a collective instead
of hanging it.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: NCCL when ``device`` is cuda (this process on
    card ``LOCAL_RANK``, else its index modulo the cards), gloo on the CPU.
    Raises without CUDA unless ``device="cpu"``; nothing falls back."""
    from ..detect_api import resolve_device
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        init = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id or 0)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_size(global_batch: int, mesh=None) -> int:
    """This process's share of ``global_batch``: over the mesh's "data" axis,
    or over every process."""
    n = mesh.shape["data"] if mesh is not None else process_count()
    assert global_batch % n == 0, (global_batch, n)
    return global_batch // n


def host_local_batch(mesh, local_tree: Any) -> Any:
    """This process's slice of the global batch (a tensor or array, or a
    dict/list/tuple of them) as tensors on its device: the slice over "data"
    that ``mesh.shard_batch`` cuts from a global batch."""
    def one(x):
        return torch.as_tensor(x).to(mesh.device)
    from .mesh import _tree_map
    return _tree_map(one, local_tree)
