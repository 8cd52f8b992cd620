"""Megatron tensor parallelism over a mesh's tp axis: the sharding rules by
state-dict name, the conjugate collectives the sharded modules call, and
the gathers back to full tensors (mirrors aladin_tpu/parallel/sharding.py).

aladin_tpu writes the rules as PartitionSpecs and lets XLA's SPMD
partitioner insert the collectives. Here each rank is one process with one
device (``torchrun``), holds its slice of each sharded weight in place, and
the modules call the collectives themselves:

  * column-parallel (output features split by heads or by FFN rows, with
    their bias): the backbone's ``attention.self.{query,key,value}`` and
    ``intermediate.dense``, the TE layers' ``linear1``, and the packed
    ``self_attn.in_proj_{weight,bias}`` of every ``TorchMultiheadAttention``
    (the TE stacks', the depth aggregator's). The packed (3E, E) projection
    gives each rank its heads' rows of each of the q, k and v blocks, not a
    contiguous third of the packed rows. Before a column-parallel layer the
    input goes through ``copy_to_tp``: the identity forward, an all-reduce
    of its gradient over tp backward;
  * row-parallel (input features split, bias replicated): the backbone's
    ``attention.output.dense`` and ``layer.N.output.dense``, the TE's
    ``self_attn.out_proj`` and ``linear2`` (``row_parallel_linear``: the
    partial product with an f32 result, all-reduced over tp forward, the
    bias added once after the reduce, rounded once to the activation dtype;
    the identity backward);
  * everything else (embeddings, LayerNorms, the pooler, the row-parallel
    biases, the heads' other layers) is replicated: a rule that matches
    nothing replicates.

Dropout under tp (Megatron's model-parallel RNG rule). A dropout on a
replicated activation must draw the same mask on every tp rank of a dp
group: the generators fold only the dp index (``cli/common.py::
shard_state_and_loaders``), and every tp rank draws the same shapes in the
same order. K2, the fused attention kernel, hashes the global head index
(``heads_total``, ``head_offset``), so its masks under tp are the tp = 1
masks bit for bit. The plain dropouts on sharded activations (the attention
probabilities, the TE's FFN hidden units) draw the whole tensor's mask from
that shared generator and keep their own slice (``sharded_dropout``): no
two heads share a mask, the generator stays in step on every tp rank, and
no second generator has to be registered with a CUDA graph. Those masks
differ from tp = 1's (``nn.Dropout``'s own draw); their distribution is
the same.

tp must divide the head counts (backbone: 12 heads; the TE stacks: 4), so
tp is 1, 2 or 4 for the stock architecture; ``check_tp`` names the layer
that refuses. The int8 encoder (``quant_matmuls``) is not sharded: it is an
evaluation path, and aladin_tpu's trainer never runs it.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from aladin_torch.parallel.mesh import Mesh, all_gather_cat

# (state-dict name regex, kind); first match wins, no match replicates
_RULES = [
    (re.compile(r"self_attn\.in_proj_(weight|bias)$"), "packed"),
    (re.compile(r"(attention\.self\.(query|key|value)|intermediate\.dense|linear1)"
                r"\.(weight|bias)$"), "column"),
    (re.compile(r"(attention\.output\.dense|(^|\.)layer\.\d+\.output\.dense|self_attn\.out_proj"
                r"|linear2)\.weight$"), "row"),
]


def spec_for(name: str) -> Optional[str]:
    """'column', 'packed' (column-parallel over each of q, k, v), 'row' or
    None (replicated) for a state-dict name."""
    for rx, kind in _RULES:
        if rx.search(name):
            return kind
    return None


# ---------------------------------------------------------------------------
# the conjugate collectives
# ---------------------------------------------------------------------------


def _all_reduce_f32(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's tp group, computed in f32, in x's
    dtype (a new tensor)."""
    buf = x.to(torch.float32, copy=True)
    if mesh.tp_group is not None:
        dist.all_reduce(buf, group=mesh.tp_group)
    return buf.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce_f32(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-parallel layer: ``x`` forward, its gradient
    summed over the tp ranks backward (each rank's layer sees its own
    columns' share of it)."""
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The output of a row-parallel layer: the partial sums added over the
    tp ranks (in f32) forward, the gradient as it is backward."""
    return _ReduceFromTP.apply(x, mesh)


class _PartialProduct(torch.autograd.Function):
    """``h @ w.T`` with an f32 result from operands of one dtype. On the card
    a 16-bit pair runs cuBLAS's tensor-core GEMM with an f32 output
    (``torch.mm(..., out_dtype=torch.float32)``: the f32 accumulator is
    written unrounded); otherwise the operands are upcast and multiplied in
    f32, the same products and sums. The backward's products take the
    operands' dtype, as the unsharded layer's do."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.is_cuda and h.dtype in (torch.bfloat16, torch.float16):
            return torch.mm(h, w.t(), out_dtype=torch.float32)
        return torch.mm(h.float(), w.float().t())

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)  # the activation-dtype gradient of the rounded output
        return (torch.mm(g, w) if ctx.needs_input_grad[0] else None,
                torch.mm(g.t(), h) if ctx.needs_input_grad[1] else None)


def row_parallel_linear(h: torch.Tensor, layer: nn.Linear, mesh: Mesh) -> torch.Tensor:
    """``layer(h)`` for a row-parallel layer holding its input columns of the
    weight: the partial product of the operands in the activation dtype
    (autocast's, else h's) with an f32 result (``_PartialProduct``), summed
    over tp in f32, plus the bias (in the activation dtype, as autocast
    casts it) once, rounded once to the activation dtype. Under bf16 the
    result is within one rounding of tp = 1's bf16 GEMM, which also sums in
    f32."""
    dev = h.device.type
    dt = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else h.dtype
    with torch.autocast(dev, enabled=False):
        x = h.to(dt)
        part = _PartialProduct.apply(x.reshape(-1, x.shape[-1]), layer.weight.to(dt))
        y = reduce_from_tp(part.view(*x.shape[:-1], -1), mesh) + layer.bias.to(dt).float()
    return y.to(dt)


def sharded_dropout(x: torch.Tensor, p: float, training: bool, mesh: Mesh,
                    dim: int) -> torch.Tensor:
    """Dropout at rate ``p`` of this rank's slice along ``dim`` of a tensor
    sharded over tp: the whole tensor's uniform draw from the default
    generator (the same on every tp rank), this rank's slice of it, kept
    where >= p and scaled by 1 / (1 - p)."""
    if not training or p == 0.0:
        return x
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * mesh.tp
    keep = torch.rand(shape, device=x.device).narrow(dim, mesh.tp_index * n, n) >= p
    return torch.where(keep, x * (1.0 / (1.0 - p)), torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


# ---------------------------------------------------------------------------
# slicing and gathering
# ---------------------------------------------------------------------------


def _split_view(t: torch.Tensor, kind: str):
    """(a view of ``t`` whose dimension ``dim`` is the one split over tp,
    dim): rows for 'column', columns for 'row', the rows of each of the
    three (q, k, v) blocks for 'packed'."""
    if kind == "packed":
        return t.reshape(3, t.shape[0] // 3, *t.shape[1:]), 1
    return t, 0 if kind == "column" else 1


def shard_tensor(t: torch.Tensor, kind: str, tp: int, index: int) -> torch.Tensor:
    """Rank ``index``'s slice of the full tensor ``t`` (a new tensor)."""
    v, dim = _split_view(t, kind)
    n = v.shape[dim] // tp
    part = v.narrow(dim, index * n, n)
    return (part.reshape(-1, *t.shape[1:]) if kind == "packed" else part).clone()


def gather_tensor(t: torch.Tensor, kind: str, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every tp rank's slice ``t`` (a collective over
    the tp group: every rank calls it, with its own slice)."""
    v, dim = _split_view(t, kind)
    full = all_gather_cat(mesh, v, dim, axis="tp")
    return full.reshape(-1, *t.shape[1:]) if kind == "packed" else full


def check_tp(model: nn.Module, tp: int) -> None:
    """Raise ``ValueError`` unless ``model`` can be sharded over ``tp``
    ranks: tp divides every attention layer's head count and every
    sharded feature count, and the model has no W8A8 layer."""
    if tp == 1:
        return
    from aladin_torch.models.quant import FusedQuantLinear, QuantLinear

    for name, m in model.named_modules():
        if isinstance(m, (QuantLinear, FusedQuantLinear)):
            raise ValueError(f"{name}: the int8 encoder (quant_matmuls) is not sharded over tp; "
                             "train in bf16 or f32")
        heads = getattr(m, "num_heads", None)
        if heads is not None and hasattr(type(m), "tp_mesh") and heads % tp:
            raise ValueError(f"tp={tp} does not divide the {heads} heads of {name}")
    for name, p in model.named_parameters():
        kind = spec_for(name)
        if kind is not None:
            v, dim = _split_view(p, kind)
            if v.shape[dim] % tp:
                raise ValueError(f"tp={tp} does not divide the {v.shape[dim]} sharded features "
                                 f"of {name}")


def is_sharded(p: torch.Tensor) -> bool:
    return getattr(p, "tp_kind", None) is not None


@torch.no_grad()
def shard_module_(model: nn.Module, mesh: Mesh,
                  optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Keep this rank's slice of every sharded parameter of ``model`` in
    place (the same ``Parameter`` objects, marked with ``tp_kind``; the
    optimizer's moments of a parameter, where it has them, sliced alike)
    and hand the mesh (``tp_mesh``) to every module that calls the
    collectives.
    Returns the number of sharded parameters; a tp axis of 1 shards
    nothing."""
    if mesh.tp == 1:
        return 0
    check_tp(model, mesh.tp)
    n = 0
    for name, p in model.named_parameters():
        kind = spec_for(name)
        if kind is None or is_sharded(p):
            continue
        full = p.shape
        p.data = shard_tensor(p.data, kind, mesh.tp, mesh.tp_index)
        p.tp_kind = kind
        n += 1
        for key, v in (optimizer.state.get(p, {}) if optimizer is not None else {}).items():
            if torch.is_tensor(v) and v.shape == full:
                optimizer.state[p][key] = shard_tensor(v, kind, mesh.tp, mesh.tp_index)
    for m in model.modules():
        if hasattr(type(m), "tp_mesh"):
            m.tp_mesh = mesh
    return n


def full_state_dict(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded tensor gathered back to its
    full shape under its own name: the reference's keys and shapes (a
    collective over tp: every rank calls it)."""
    sd = model.state_dict()
    if mesh is None or mesh.tp == 1:
        return sd
    params = dict(model.named_parameters())
    return {k: gather_tensor(v, params[k].tp_kind, mesh)
            if k in params and is_sharded(params[k]) else v for k, v in sd.items()}


def full_optimizer_state(sd: Dict, params: List[nn.Parameter], mesh: Optional[Mesh]) -> Dict:
    """An optimizer state dict (``params``: the optimizer's parameters in its
    index order) with the moments of sharded parameters gathered to their
    full shapes (a collective over tp)."""
    if mesh is None or mesh.tp == 1:
        return sd
    state = {}
    for i, st in sd["state"].items():
        p = params[i]
        state[i] = {k: gather_tensor(v, p.tp_kind, mesh)
                    if is_sharded(p) and torch.is_tensor(v) and v.shape == p.shape else v
                    for k, v in st.items()}
    return {**sd, "state": state}


def global_norm_tp(params: Iterable[nn.Parameter], mesh: Optional[Mesh]) -> torch.Tensor:
    """The global norm of the parameters' gradients as one unsharded model
    would have them: squares of sharded gradients summed over the tp group,
    replicated ones counted once (an f32 device scalar)."""
    grads = [(p.grad, is_sharded(p)) for p in params if p.grad is not None]
    zero = torch.zeros((), dtype=torch.float32, device=grads[0][0].device)
    sharded = sum((torch.sum(torch.square(g.float())) for g, s in grads if s), zero)
    if mesh is not None and mesh.tp_group is not None:
        sharded = sharded.clone()
        dist.all_reduce(sharded, group=mesh.tp_group)
    return torch.sqrt(sharded + sum((torch.sum(torch.square(g.float()))
                                     for g, s in grads if not s), zero))
