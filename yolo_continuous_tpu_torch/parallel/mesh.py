"""Process mesh and sharding (counterpart of ``yolo_continuous_tpu/parallel/mesh.py``).

The JAX package names a device mesh with ``("data", "model")`` axes and lets
GSPMD place the collectives: the batch is sharded over "data", the widest
convolution kernels' output channels over "model", everything else is
replicated. The port runs one process a device
(``parallel/distributed.initialize``) and writes the collectives that GSPMD
would insert, over the two process groups of a
``torch.distributed.device_mesh.DeviceMesh``:

- the batch: each rank feeds its slice of the global batch over "data"
  (replicated over "model", ``shard_batch``);
- train-mode BatchNorm takes its statistics over the global batch: the fp32
  means of x and x^2 of the rank's slice are summed over "data" (the local
  counts are equal) through ``all_reduce_sum``, whose backward sums the
  gradients, as SyncBatchNorm does (``nn/layers.BatchNorm2d``);
- the loss is the sum of the ranks' contributions: every normalizer of the
  loss (the foreground counts, the objectness element count) is summed over
  "data" without a gradient (``global_count``), and the gradients are then
  summed over "data" (``sum_gradients``), not averaged as DDP does;
- a convolution whose kernel ``param_sharding_rule`` shards keeps its slice
  of the output channels. Its input passes through ``copy_to_model``
  (identity forward, gradients summed over "model" backward), and its output
  through ``gather_from_model`` (all-gather over "model"; backward, the
  rank's slice of the gradient, which is the same on every rank of "model"
  because everything after the gather is replicated there), so BatchNorm and
  the activation see whole channels, as GSPMD gives them. A sharded
  implicit is gathered before use.

The optimizer and the EMA run on each rank's shards; ``gather_params``
assembles whole tensors for checkpoints and tests. With a world of one,
every collective is the identity and the step is bit-equal to the plain one.

The mesh is active inside ``use_mesh`` (the ``Trainer``'s train step, its
forward and its backward, where a recomputed forward needs it too, and its
eval loss); it is a process-wide setting, as one process trains one model.

Nothing here copies from the host or waits for the card inside a step, so
over NCCL groups a CUDA graph holds the step with its collectives
(``Trainer.jitted_train_step``; the communicator is made by the first,
eager call). A gloo collective runs on the host, and a gloo mesh's step
stays eager.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


class Mesh:
    """A (data, model) mesh of processes, one device each: the
    ``DeviceMesh``, its axis sizes ``shape``, this rank's device, groups
    and coordinates."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        names = device_mesh.mesh_dim_names
        self.shape = {n: device_mesh.size(i) for i, n in enumerate(names)}
        self.data_group = device_mesh.get_group("data")
        self.model_group = device_mesh.get_group("model")
        self.data_rank = device_mesh.get_local_rank("data")
        self.model_rank = device_mesh.get_local_rank("model")

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, {self.device})"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, devices=None) -> Mesh:
    """The mesh of every process of the group (``distributed.initialize``
    first), ``n_data`` x ``n_model`` in rank order, with dims ("data",
    "model"). ``devices``: the device type ("cuda" or "cpu"), by default the
    group's: "cuda" for NCCL, "cpu" for gloo."""
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call parallel.distributed.initialize")
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh over {world} processes")
    kind = devices or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    device = torch.device(kind, torch.cuda.current_device()) if kind == "cuda" else torch.device(kind)
    dm = init_device_mesh(kind, (n_data, n_model), mesh_dim_names=("data", "model"))
    return Mesh(dm, device)


def data_sharding(mesh: Mesh, ndim: int):
    """Placements of a batch tensor: its leading axis sharded over "data",
    replicated over "model"."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate())


def replicated(mesh: Mesh):
    """Placements of a replicated tensor."""
    from torch.distributed.tensor import Replicate
    return (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# the active mesh and its collectives
# ---------------------------------------------------------------------------

_ACTIVE = [None]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """BatchNorm and the loss reduce over ``mesh``'s "data" axis inside this
    scope (None: no mesh)."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = mesh
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE[0]


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the gradients over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, with its gradient (the sum of the
    ranks' output gradients)."""
    return _AllReduceSum.apply(x, group)


def global_count(x: torch.Tensor) -> torch.Tensor:
    """A loss normalizer summed over the active mesh's "data" axis, without a
    gradient; ``x`` itself without a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.data_group)
    return out


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The rank's share of the mean over the global batch: ``x.mean()``
    scaled by the local over the global element count (summed over "data"),
    a factor of exactly 1 with one rank."""
    if active_mesh() is None:
        return x.mean()
    n = torch.full((), float(x.numel()), device=x.device)     # a fill, no copy from the host
    return x.mean() * (n / global_count(n))


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward, the gradients summed over "model" (each
    rank's shard of a convolution contributes its output channels' part)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.model_group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather over "model" along ``dim``; backward, the rank's slice of
    the gradient (the same gradient on every rank of "model": what follows
    the gather is replicated there)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        parts = [torch.empty_like(x) for _ in range(mesh.shape["model"])]
        dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.mesh.shape["model"]
        return grad.chunk(n, ctx.dim)[ctx.mesh.model_rank].contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, mesh, dim)


def sharded_conv(conv, x: torch.Tensor, weight: torch.Tensor, mesh: Mesh,
                 groups: int) -> torch.Tensor:
    """A convolution whose ``weight`` holds this rank's slice of the output
    channels (axis 0), gathered to whole channels over "model".
    ``conv(x, weight, groups)`` computes the local convolution. A grouped
    convolution takes the input channels of the groups its slice covers; a
    slice that covers parts of two groups gathers the weight instead."""
    n, r = mesh.shape["model"], mesh.model_rank
    c2, c1 = weight.shape[0] * n, x.shape[1]
    if groups == 1:
        return gather_from_model(conv(copy_to_model(x, mesh), weight, 1), mesh, 1)
    per_group, per_rank, cin = c2 // groups, c2 // n, c1 // groups
    if per_rank % per_group == 0:           # the slice covers whole groups
        g = per_rank // per_group
        lo, hi = r * g * cin, (r + 1) * g * cin
    elif per_group % per_rank == 0:         # the slice lies inside one group
        g, first = 1, r * per_rank // per_group
        lo, hi = first * cin, (first + 1) * cin
    else:                                   # replicated: every rank the whole conv
        return conv(x, gather_from_model(weight, mesh, 0), groups)
    return gather_from_model(conv(copy_to_model(x, mesh)[:, lo:hi], weight, g), mesh, 1)


def sum_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Every parameter's gradient summed over "data", in one collective."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=mesh.data_group)
    for p, g in zip(params, _unflatten_dense_tensors(flat, grads)):
        p.grad = g


# ---------------------------------------------------------------------------
# parameter sharding
# ---------------------------------------------------------------------------

def shard_axis(name: str) -> int:
    """The torch axis of a 4-D parameter that is the last axis of its flax
    leaf: the output channels of a convolution kernel (flax ``(kh, kw, cin,
    cout)``, torch ``(cout, cin, kh, kw)``; the transposed convolution keeps
    ``(c2, c1, s, s)``), the channels of an implicit (flax ``(1, 1, 1, c)``,
    torch ``(1, c, 1, 1)``)."""
    return 1 if name.rsplit(".", 1)[-1] == "implicit" else 0


def param_sharding_rule(mesh, min_channels: int = 256):
    """JAX's rule (``mesh.py:47-64``) on the port's parameters: ``rule(name,
    tensor)`` gives the axis to shard over "model", or None to replicate.
    It picks every 4-D leaf whose last flax axis (``shard_axis``) has at
    least ``min_channels`` entries and divides by the "model" size, when that
    size is above 1: the convolution kernels, the implicits and, through
    ``shard_params``, their optimizer buffers."""
    n_model = mesh.shape["model"]

    def rule(name: str, x: torch.Tensor) -> Optional[int]:
        if n_model > 1 and x.ndim == 4:
            axis = shard_axis(name)
            if x.shape[axis] >= min_channels and x.shape[axis] % n_model == 0:
                return axis
        return None

    return rule


def _shardable(module) -> bool:
    from ..nn import layers as L
    return isinstance(module, (L.BodyConv2d, L.LogitConv, L.ConvTranspose, L.ImplicitA,
                               L.ImplicitM))


def shard_params(mesh: Mesh, model_or_state, min_channels: int = 256):
    """Keep this rank's slice of every parameter the rule picks, in place:
    a ``YoloModel``, or a ``Trainer.init_state`` dict (its model, the
    optimizer's buffers of those parameters and their EMA entries). The
    sharded modules compute through ``sharded_conv`` / ``gather_from_model``;
    ``model.shards`` maps each sharded state-dict key to its axis. Returns
    its argument."""
    state = model_or_state if isinstance(model_or_state, dict) else None
    model = state["model"] if state is not None else model_or_state
    rule = param_sharding_rule(mesh, min_channels)
    n, r = mesh.shape["model"], mesh.model_rank
    shards: Dict[str, int] = {}
    for mname, m in model.named_modules():
        for pname, p in list(m.named_parameters(recurse=False)):
            key = f"{mname}.{pname}" if mname else pname
            axis = rule(key, p)
            if axis is None:
                continue
            if not _shardable(m):
                raise NotImplementedError(f"{key}: {type(m).__name__} has no sharded forward")
            full = p.shape
            p.data = p.data.chunk(n, axis)[r].contiguous()
            m.mesh = mesh
            shards[key] = axis
            if state is None:
                continue
            bufs = state["opt"].state.get(p, {})
            for k, buf in bufs.items():
                if torch.is_tensor(buf) and buf.shape == full:
                    bufs[k] = buf.chunk(n, axis)[r].contiguous()
            ema = state["ema"].tree
            if key in ema:
                ema[key] = ema[key].chunk(n, axis)[r].contiguous()
    model.shards = shards
    return model_or_state


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's slice over "data" of every tensor of a global batch (a
    tensor, array, or a dict/list/tuple of them), on the mesh's device."""
    def one(x):
        x = torch.as_tensor(x)
        return x.chunk(mesh.shape["data"], 0)[mesh.data_rank].to(mesh.device)
    return _tree_map(one, batch)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _gather(mesh: Mesh, x: torch.Tensor, axis: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, x.contiguous(), group=mesh.model_group)
    return torch.cat(parts, axis)


def full_state_dict(mesh: Mesh, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every sharded entry gathered whole."""
    shards = getattr(model, "shards", {})
    return {k: _gather(mesh, v, shards[k]) if k in shards else v
            for k, v in model.state_dict().items()}


def gather_params(mesh: Mesh, state: Dict[str, Any]) -> Dict[str, Any]:
    """Whole tensors of a (sharded) train state, what JAX's serializer reads
    from sharded arrays: ``model`` (a state dict), ``ema`` (its tree and
    counter) and ``step``."""
    model = state["model"]
    shards = getattr(model, "shards", {})
    ema = {k: _gather(mesh, v, shards[k]) if k in shards else v
           for k, v in state["ema"].tree.items()}
    return {"model": full_state_dict(mesh, model),
            "ema": {"tree": ema, "updates": state["ema"].updates}, "step": state["step"]}
