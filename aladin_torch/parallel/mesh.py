"""Device meshes over a ``torch.distributed`` process group, the collectives
the port's sharded paths use, and corpus-sharded scoring (mirrors
aladin_tpu/parallel/mesh.py).

In aladin_tpu a mesh is one controller over many devices, and a sharded
function is a ``shard_map``. Here each rank is one process with one device
(``torchrun``, one process a GPU): it runs the local body of that
``shard_map`` on its own device, and the ``out_specs`` concatenation along
the sharded axis is an ``all_gather``. The layouts are the reference's:

  * training: a 2-D mesh (dp, tp), the rank ``dp_index * tp + tp_index``
    (tp the fastest axis, as aladin_tpu reshapes its devices (dp, tp)):
    the batch over dp (``train/step.py``: the loss's gathers and the
    gradient all-reduce go over the dp group) and Megatron tensor
    parallelism over tp (``parallel/sharding.py``: each rank holds its
    heads' and its FFN rows' slices, and the model's conjugate collectives
    go over the tp group);
  * evaluation: the retrieval corpus shards over every rank, dp and tp
    alike (``_flat_axes`` in aladin_tpu). Images are
    replicated, rank r scores caption block r with the single-device scorer
    (the MrSw kernel K1 on the card, its plain version on the CPU), and one
    all-gather assembles the (N_im, N_cap) matrix. int8 scales are taken
    per call, so per shard, as inside aladin_tpu's ``shard_map``; in bf16
    K1's scores do not depend on the shape, so sharded scores equal
    unsharded ones bit for bit on the card.

A mesh asks for exactly the ranks of the process group: more raises, and so
does fewer (a run of one rank needs no mesh: ``cli/common.py::
maybe_create_mesh`` returns None).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from aladin_torch.ops.alignment import score_all_pairs
from aladin_torch.ops.kernels.alignment_kernel import mrsw_scores
from aladin_torch.parallel.distributed import collective_device, get_rank, get_world_size

def parse_mesh_shape(spec: str, n_devices: Optional[int] = None) -> Dict[str, int]:
    """Parse "dp=4,tp=2" (one -1 axis absorbs the remaining ranks of
    ``n_devices``, by default the world size)."""
    n = n_devices if n_devices is not None else get_world_size()
    axes: Dict[str, int] = {}
    for part in spec.split(","):
        name, _, val = part.strip().partition("=")
        axes[name] = int(val) if val else -1
    fill = [k for k, v in axes.items() if v == -1]
    if len(fill) > 1:
        raise ValueError(f"at most one -1 axis: {spec}")
    fixed = int(np.prod([v for v in axes.values() if v != -1])) or 1
    if fill:
        if n % fixed:
            raise ValueError(f"{spec}: {n} ranks do not divide by the fixed axes' {fixed}")
        axes[fill[0]] = n // fixed
    return axes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axes of a mesh over the default process group, this rank and
    its device. ``group`` spans every rank; ``dp_group`` and ``tp_group``
    are this rank's sub-groups along each axis (the ranks that share its
    tp index, and those that share its dp index). A group is None where it
    would hold this rank alone (a mesh of one process without a process
    group, or an axis of size 1): every collective over it is then the
    identity."""

    axes: Dict[str, int]
    group: Optional[dist.ProcessGroup]
    rank: int
    device: torch.device
    dp_group: Optional[dist.ProcessGroup] = None
    tp_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return int(np.prod(list(self.axes.values())))

    @property
    def dp(self) -> int:
        return self.axes.get("dp", 1)

    @property
    def tp(self) -> int:
        return self.axes.get("tp", 1)

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    def axis_group(self, axis: Optional[str]):
        """(the group of ``axis``: None = every rank, 'dp' or 'tp'; this
        rank's index in it)."""
        if axis is None:
            return self.group, self.rank
        if axis == "dp":
            return self.dp_group, self.dp_index
        if axis == "tp":
            return self.tp_group, self.tp_index
        raise ValueError(f"mesh axes are dp and tp, got {axis!r}")


def _axis_groups(dp: int, tp: int, rank: int):
    """(dp group, tp group) of ``rank`` on a (dp, tp) mesh over the default
    group. Every rank creates every sub-group, in the same order, as
    ``dist.new_group`` requires; an axis of size 1 has no group, and an
    axis that spans the whole mesh is the default group."""
    if dp * tp == 1:
        return None, None
    world = dist.group.WORLD
    dp_group = tp_group = None
    if dp > 1:
        dp_group = world if tp == 1 else None
        for t in range(tp if tp > 1 else 0):
            g = dist.new_group([d * tp + t for d in range(dp)])
            if t == rank % tp:
                dp_group = g
    if tp > 1:
        tp_group = world if dp == 1 else None
        for d in range(dp if dp > 1 else 0):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if d == rank // tp:
                tp_group = g
    return dp_group, tp_group


def mesh_axes(spec: str, n_devices: Optional[int] = None) -> Dict[str, int]:
    """The axes of a "dp=N,tp=M" spec (``parse_mesh_shape``), checked to
    be dp and tp only."""
    axes = parse_mesh_shape(spec, n_devices)
    unknown = set(axes) - {"dp", "tp"}
    if unknown:
        raise ValueError(f"mesh axes are dp and tp, got {sorted(unknown)} in {spec!r}")
    return axes


def create_mesh(spec: str = "dp=-1", device=None) -> Mesh:
    """Mesh from a "dp=N,tp=M" spec over the default process group: rank
    ``dp_index * tp + tp_index``, the dp and tp sub-groups created on every
    rank. ``device``: this rank's device (default: its card under NCCL,
    else the CPU)."""
    world = get_world_size()
    axes = mesh_axes(spec, world)
    size = int(np.prod(list(axes.values())))
    if size != world:
        raise ValueError(f"mesh {spec!r} spans {size} ranks; the process group has {world} "
                         f"(start one process a device: torchrun --nproc_per_node {size})")
    rank = get_rank()
    group = dist.group.WORLD if dist.is_initialized() else None
    dp_group, tp_group = _axis_groups(axes.get("dp", 1), axes.get("tp", 1), rank)
    device = collective_device() if device is None else torch.device(device)
    return Mesh(axes, group, rank, device, dp_group, tp_group)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_gather_cat(mesh: Mesh, x: torch.Tensor, dim: int = 0,
                   axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along ``dim`` in rank
    order: the ``out_specs`` concatenation of a ``shard_map``. ``axis``:
    None gathers over every rank, 'dp' / 'tp' over this rank's sub-group
    of that axis. The gather runs on the collectives' device (gloo has no
    all-gather of CUDA tensors: a CUDA tensor under gloo goes through host
    memory)."""
    group, _ = mesh.axis_group(axis)
    if group is None:
        return x
    buf = x.contiguous().to(collective_device())
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def all_reduce_sum_(mesh: Mesh, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
    """Sum ``x`` over the ranks (of ``axis``'s group, as in
    ``all_gather_cat``) in place (``lax.psum``); returns ``x``."""
    group, _ = mesh.axis_group(axis)
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def broadcast_(mesh: Mesh, tensors) -> None:
    """Overwrite each tensor with the mesh's rank 0's, in place (a tensor
    off the collectives' device goes through a copy on it)."""
    if mesh.group is None:
        return
    dev = collective_device()
    src = dist.get_global_rank(mesh.group, 0)
    for t in tensors:
        buf = t if t.device == dev else t.to(dev)
        dist.broadcast(buf, src=src, group=mesh.group)
        if buf is not t:
            t.copy_(buf)


class _GatherRows(torch.autograd.Function):
    """all_gather along dim 0 whose backward sums the full gradient over the
    ranks and keeps this rank's rows (a reduce-scatter, written as an
    all-reduce, which gloo has too)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return all_gather_cat(mesh, x, 0, axis)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum_(ctx.mesh, g.contiguous().clone(), ctx.axis)
        lo = ctx.mesh.axis_group(ctx.axis)[1] * ctx.rows
        return g[lo:lo + ctx.rows], None, None


def gather_rows(mesh: Mesh, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's rows of ``x`` stacked in rank order (over ``axis``'s
    group, as in ``all_gather_cat``), with a gradient: where every rank
    reduces the same loss from the gathered rows, each rank's rows get the
    sum of all ranks' gradients, that is the group's size times the
    loss's."""
    if mesh.axis_group(axis)[0] is None:
        return x
    return _GatherRows.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# corpus-sharded scoring
# ---------------------------------------------------------------------------


def sharded_mrsw_scores(mesh: Mesh, im_set, s_seq, im_len, s_len, aggregation: str = "MrSw",
                        use_kernel: Optional[bool] = None, compute_dtype=torch.bfloat16,
                        small_corpus_fallback: bool = True) -> torch.Tensor:
    """(N_im, N_cap) alignment scores with the caption axis sharded over the
    mesh, the same (full) matrix on every rank, on ``mesh.device``.

    The caption axis pads to a multiple of ``mesh.size * 128`` (zero rows,
    length 4) and rank r scores block r against every image: with
    ``mrsw_scores`` for 'MrSw' when ``use_kernel`` (default: the device is
    CUDA, or int8 scoring), else ``score_all_pairs`` in f32. Below one full
    128-caption tile a rank (``small_corpus_fallback``), every rank scores
    the whole corpus itself instead.
    """
    device = mesh.device
    n_dev = mesh.size
    if use_kernel is None:
        use_kernel = device.type == "cuda" or compute_dtype == torch.int8
    take_kernel = aggregation == "MrSw" and use_kernel
    ims = torch.as_tensor(im_set, dtype=torch.float32, device=device)
    caps = torch.as_tensor(s_seq, dtype=torch.float32, device=device)
    il = torch.as_tensor(im_len, device=device)
    cl = torch.as_tensor(s_len, device=device)
    n_cap = caps.shape[0]

    def score(c, c_len):
        if take_kernel:
            return mrsw_scores(ims, c, il, c_len, compute_dtype=compute_dtype)
        return score_all_pairs(ims, c, il, c_len, aggregation, 128)

    if small_corpus_fallback and n_cap < n_dev * 128:
        # a minival-sized corpus padded to n_dev * 128 would score mostly
        # padding on every rank; below one full tile a rank, scoring the
        # whole corpus on each rank is cheaper
        return score(caps, cl)

    pad = (-n_cap) % (n_dev * 128)
    caps = F.pad(caps, (0, 0, 0, 0, 0, pad))
    cl = F.pad(cl, (0, pad), value=4)
    shard = (n_cap + pad) // n_dev
    lo = mesh.rank * shard
    local = score(caps[lo:lo + shard], cl[lo:lo + shard])
    return all_gather_cat(mesh, local.float(), dim=1)[:, :n_cap]


@torch.no_grad()
def sharded_matching_scores(mesh: Mesh, img_glob, cap_glob) -> torch.Tensor:
    """(N_im, N_cap) f32 global-embedding dot scores, the caption axis
    sharded over the mesh (padded to a multiple of its size), the full
    matrix on every rank."""
    device = mesh.device
    ims = torch.as_tensor(img_glob, dtype=torch.float32, device=device)
    caps = torch.as_tensor(cap_glob, dtype=torch.float32, device=device)
    n_cap = caps.shape[0]
    pad = (-n_cap) % mesh.size
    caps = F.pad(caps, (0, 0, 0, pad))
    shard = (n_cap + pad) // mesh.size
    lo = mesh.rank * shard
    return all_gather_cat(mesh, ims @ caps[lo:lo + shard].T, dim=1)[:, :n_cap]
