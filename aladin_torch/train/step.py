"""The training step: forward, loss composition, backward, clip, Adam
(mirrors aladin_tpu/train/step.py, eagerly).

Loss composition:
  * the matching score matrix is always computed (distillation needs it);
  * the alignment head runs when 'alignment' or 'distillation' is active;
    its score matrix is the in-model teacher, detached before distillation;
  * 'selfaggregation' contributes the matching loss under its own key;
  * the distillation margin is always 0.2, not training.margin;
  * the distillation term is gated off while epoch < distill_epoch, unless
    it is the only loss, and the gate zeroes the whole term, its +s too;
  * fixed weights: total = sum w_k L_k; auto: 0.5 * sum(L_k e^{-s_k} + s_k).

``compute_dtype=torch.bfloat16`` runs the forward under autocast with f32
parameters and f32 gradients, as aladin_tpu runs its bf16 model over f32
parameters. Metrics come back as device tensors; nothing here waits for the
card.

Memory levers, as in aladin_tpu: ``BertImgConfig.remat`` checkpoints each
backbone layer (models/bert_img.py), and ``training.encoder-microbatch`` runs
the whole model over micro-batches under checkpoints
(``encode_microbatched``) while the losses see the whole batch.

Data parallelism (``mesh=``, a ``parallel/mesh.py`` mesh over ``dp``
ranks, each with B / dp rows of the global batch): as aladin_tpu's SPMD
step, the losses are the global batch's. Each rank runs the model on its
rows; the global embeddings and the caption token sets are gathered with
a gradient; each rank computes its own row block of the alignment matrix
(its images against every caption), so the B x B x R x W work is split
over the ranks, and the blocks are gathered with a gradient. Every rank
then reduces the same global loss from the same B x B matrices. A
gather's backward sums the ranks' gradients, so each rank's parameter
gradients are dp times its share of the loss's; one all-reduce of a flat
buffer of every gradient, divided by dp, gives the loss's gradient on
every rank, before ``grad_norm``, the clip and Adam. There is no
``DistributedDataParallel``: its hooks are not part of the step that a CUDA
graph captures, and this all-reduce is.

Tensor parallelism (a mesh with a tp axis, the model sharded by
``parallel/sharding.py::shard_module_``): the tp ranks of a dp group hold
the same rows, so the gathers and the gradient all-reduce above run over
the dp group only, and the mean divides by dp. The model's own collectives
(over the tp group) make every replicated parameter's gradient whole on
each tp rank; ``grad_norm`` and the clip sum the squares of the sharded
gradients over tp and count the replicated ones once, so the norm is the
unsharded model's. Adam's moments follow the local shards.

``make_multi_train_step`` runs a window of K steps as one dispatch, the
counterpart of aladin_tpu's jitted ``lax.scan``: on the card one CUDA graph
that captured K consecutive steps over K static batch buffers, replayed once
a window; on the CPU, K eager steps. Either way the window equals K single
steps bit for bit: the same kernels in the same order, dropout from the same
Philox offsets (a graph advances the CUDA generator by what the captured
steps draw), the learning rates of the same schedule counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from aladin_torch.config import ExperimentConfig
from aladin_torch.models.aladin import ALADIN, AladinOutputs, Batch
from aladin_torch.ops import losses as L
from aladin_torch.ops.alignment import alignment_scores, alignment_scores_chunked
from aladin_torch.parallel.mesh import Mesh, all_gather_cat, all_reduce_sum_, gather_rows
from aladin_torch.train.state import TrainState


def compute_autocast(device: torch.device, dtype: Optional[torch.dtype]):
    """autocast to ``dtype`` on ``device``'s type; nothing for None or f32."""
    if dtype is None or dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


_FIELDS = tuple(f.name for f in dataclasses.fields(Batch))


def encode_microbatched(model: ALADIN, batch: Batch, microbatch: int) -> AladinOutputs:
    """The whole batch's outputs, the model run over micro-batches of
    ``microbatch`` rows, each under a non-reentrant checkpoint: only each
    micro-batch's outputs outlive its forward, and the backward runs it
    again. The losses still see the whole batch (its B x B score
    matrices), so they equal the unsplit run's; the GEMMs run at another M,
    and dropout draws differ from the unsplit run's (as in aladin_tpu,
    which folds the micro-batch index into its key). ``l1_reg`` is the mean
    of the micro-batches' values."""
    b = batch.txt_ids.shape[0]
    if b % microbatch:
        raise ValueError(f"encoder-microbatch {microbatch} does not divide the batch of {b}")
    gen = model.oscar_model.bert.seed_generator

    def run(*fields):
        return model(Batch(*fields))

    outs = [checkpoint(run, *(getattr(batch, f)[i:i + microbatch] for f in _FIELDS),
                       use_reentrant=False, context_fn=lambda: _replay_generator(gen))
            for i in range(0, b, microbatch)]
    merged = {f.name: torch.cat([getattr(o, f.name) for o in outs])
              for f in dataclasses.fields(AladinOutputs) if f.name != "l1_reg"}
    return AladinOutputs(**merged, l1_reg=torch.stack([o.l1_reg for o in outs]).mean())


def _replay_generator(gen: torch.Generator):
    """checkpoint's (forward, recompute) contexts for a generator that
    checkpoint does not restore itself: the recompute draws from the state
    the forward drew from (the K2 seeds of a model on the CPU), and leaves
    ``gen`` as it found it."""
    saved = {}

    @contextlib.contextmanager
    def forward():
        saved["state"] = gen.get_state()
        yield

    @contextlib.contextmanager
    def recompute():
        now = gen.get_state()
        gen.set_state(saved["state"])
        try:
            yield
        finally:
            gen.set_state(now)

    return forward(), recompute()


def make_loss_fn(model: ALADIN, cfg: ExperimentConfig,
                 compute_dtype: Optional[torch.dtype] = None,
                 mesh: Optional[Mesh] = None) -> Callable:
    """(aux params, batch, epoch, distill_gate=None) -> (total loss,
    {name_loss: term, loss}). The forward runs under autocast to
    ``compute_dtype``; the losses take its f32 outputs and stay in f32.
    ``distill_gate``: a device scalar (1 or 0) that replaces the host's
    ``epoch >= activate-distillation-after``, so a CUDA graph reads the gate
    of the epoch it is replayed in. ``mesh``: ``batch`` holds this rank's
    rows, and the loss is the global batch's (module docstring), the same
    on every rank."""
    tc = cfg.training
    types = tc.loss_types
    mb = tc.encoder_microbatch

    def gather(x):
        return x if mesh is None else gather_rows(mesh, x, axis="dp")

    def alignment_matrix(out: AladinOutputs) -> torch.Tensor:
        """This rank's images against every caption, the blocks stacked."""
        caps, cap_len = gather(out.cap_seq), out.cap_len
        if mesh is not None:
            cap_len = all_gather_cat(mesh, cap_len, axis="dp")
        if tc.alignment_chunk > 0:
            block = alignment_scores_chunked(out.img_set, caps, out.img_len, cap_len,
                                             tc.alignment_mode, tc.alignment_chunk,
                                             normalized=True)
        else:
            block = alignment_scores(out.img_set, caps, out.img_len, cap_len, tc.alignment_mode,
                                     normalized=True)
        return gather(block)

    def loss_fn(aux: Dict[str, torch.Tensor], batch: Batch, epoch: int,
                distill_gate: Optional[torch.Tensor] = None):
        with compute_autocast(batch.txt_ids.device, compute_dtype):
            if mb and batch.txt_ids.shape[0] > mb:
                out = encode_microbatched(model, batch, mb)
            else:
                out = model(batch)
        img_global, cap_global = gather(out.img_global), gather(out.cap_global)
        terms: Dict[str, torch.Tensor] = {}
        matching_loss, matching_mat = L.matching_loss(img_global, cap_global, tc.margin,
                                                      tc.measure, tc.max_violation)
        if "matching" in types:
            terms["matching"] = matching_loss
        teacher = None
        if "alignment" in types or "distillation" in types:
            teacher = alignment_matrix(out)
            if "alignment" in types:
                terms["alignment"] = L.contrastive_hinge(teacher, tc.margin, tc.max_violation)
        if "selfaggregation" in types:
            terms["selfaggregation"] = matching_loss
        if "distillation" in types:
            terms["distillation"] = L.distillation_loss(
                teacher.detach(), matching_mat, tc.distillation_mode, wb=aux.get("distill_wb"),
                margin=0.2)
        if "entropy" in types:
            terms["entropy"] = L.entropy_uniformity_loss(img_global, cap_global)
        if "regularizehidden" in types:
            terms["regularizehidden"] = (out.l1_reg if mesh is None
                                         else gather(out.l1_reg[None]).mean())

        gates = {k: 1.0 for k in terms}
        if "distillation" in terms and len(terms) > 1:
            gates["distillation"] = (float(epoch >= tc.activate_distillation_after)
                                     if distill_gate is None else distill_gate)
        total = torch.zeros((), dtype=torch.float32, device=matching_mat.device)
        for k, v in terms.items():
            if tc.auto_weight:
                s = aux[f"loss_weights.{k}"].squeeze()
                total = total + gates[k] * 0.5 * (v * torch.exp(-s) + s)
            else:
                total = total + gates[k] * tc.weight_for(k) * v
        metrics = {f"{k}_loss": v for k, v in terms.items()}
        metrics["loss"] = total
        return total, metrics

    return loss_fn


def _update(model: ALADIN, loss_fn: Callable, state: TrainState, batch: Batch, epoch: int,
            lr: Optional[torch.Tensor] = None, distill_gate: Optional[torch.Tensor] = None,
            mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """The body of one step (see ``make_train_step``); ``lr`` and
    ``distill_gate``: device scalars a CUDA graph reads instead of the
    host's schedule value and epoch; ``mesh``: the gradients are averaged
    over its ranks first."""
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    for p in state.frozen:
        p.grad = None
    total, metrics = loss_fn(state.aux, batch, epoch, distill_gate)
    total.backward()
    if mesh is not None:
        average_gradients(mesh, [p.grad for p in state.parameters() if p.grad is not None])
    metrics["grad_norm"] = state.grad_norm(state.parameters())
    state.apply_gradients(lr)
    return {k: v.detach() for k, v in metrics.items()}


def average_gradients(mesh: Mesh, grads: List[torch.Tensor]) -> None:
    """Replace each gradient by its mean over the mesh's dp ranks: one
    all-reduce of one flat buffer over the dp group, in place."""
    if not grads or mesh.dp_group is None:
        return
    flat = all_reduce_sum_(mesh, torch.cat([g.reshape(-1) for g in grads]), axis="dp")
    flat.div_(mesh.dp)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def make_train_step(model: ALADIN, cfg: ExperimentConfig,
                    compute_dtype: Optional[torch.dtype] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """(state, batch, epoch) -> metrics: one update of ``state`` in place;
    metrics are detached device scalars, ``grad_norm`` (over every
    gradient, before the clip) included. ``mesh``: the data-parallel step
    over this rank's rows of the global batch (module docstring)."""
    loss_fn = make_loss_fn(model, cfg, compute_dtype, mesh)

    def train_step(state: TrainState, batch: Batch, epoch: int) -> Dict[str, torch.Tensor]:
        return _update(model, loss_fn, state, batch, epoch, mesh=mesh)

    return train_step


def make_multi_train_step(model: ALADIN, cfg: ExperimentConfig,
                          compute_dtype: Optional[torch.dtype] = None,
                          k: int = 2, mesh: Optional[Mesh] = None) -> Callable:
    """(state, batches, epoch) -> metrics stacked (len(batches),): a window
    of up to ``k`` steps as one dispatch, equal to as many single steps
    (``make_train_step``) bit for bit.

    On the card, the first window of ``k`` batches is captured as one CUDA
    graph (``CapturedWindow``, kept as ``multi_step.window``) and every
    window of ``k`` replays it: the batches are copied into the graph's
    static buffers on the current stream, so they are ordered after the
    loader's copies, and the metrics come back as a copy of the graph's
    (k,) slots. A shorter window (an epoch's remainder) and every window on
    the CPU run as single steps, one after another. With ``mesh`` the
    graph captures the data-parallel step's collectives too."""
    if k < 1:
        raise ValueError(f"steps per dispatch must be >= 1, got {k}")
    single = make_train_step(model, cfg, compute_dtype, mesh)
    loss_fn = make_loss_fn(model, cfg, compute_dtype, mesh)

    def multi_step(state: TrainState, batches: List[Batch], epoch: int) -> Dict[str, torch.Tensor]:
        if not 1 <= len(batches) <= k:
            raise ValueError(f"a window holds 1..{k} batches, got {len(batches)}")
        if len(batches) < k or batches[0].txt_ids.device.type != "cuda":
            rows = [single(state, b, epoch) for b in batches]
            return {name: torch.stack([r[name] for r in rows]) for name in rows[0]}
        if multi_step.window is None:
            multi_step.window = CapturedWindow(model, cfg, loss_fn, state, batches, mesh)
        return multi_step.window.replay(state, batches, epoch)

    multi_step.window = None
    return multi_step


class CapturedWindow:
    """``n`` consecutive train steps captured as one CUDA graph.

    Before the capture, one step runs eagerly on the capture stream, so that
    every lazy first-call cost (libraries loaded, Triton compiled, cuBLAS
    workspaces, Adam's moments) happens outside it; the trainable
    parameters, the optimizer's moments and the CUDA generator are then put
    back as they were, so the window starts from the caller's state (Adam
    moments the warm-up created are zeroed in place: a fresh Adam state is
    zeros). The graph reads its inputs from static buffers that ``replay``
    fills: the batches, the window's learning rates and the distillation
    gate. The host's ``state.step`` advances by ``n`` after each replay.

    Autocast keeps its weight-cast cache inside the capture, as the eager
    step does: each step's autocast region begins and ends inside the
    graph, so the cache is filled and cleared there. Without it the two
    backbone passes would each cast a weight and sum its two gradients in
    f32 instead of in bf16, and the window would not equal the eager steps.

    The memory levers capture too: non-reentrant checkpoint's stash and
    restore of the CUDA generator's state for the recompute happen inside
    the capture, so a window with remat or micro-batches equals its eager
    steps bit for bit (``tests/test_torch_gpu.py``, torch 2.11 + CUDA 12.8).

    With ``mesh`` the data-parallel step's NCCL collectives (the gathers,
    their backward all-reduces and the gradient all-reduce) are issued on
    the capture stream and captured with the window; a capture that NCCL
    refuses raises, it never falls back to eager steps."""

    def __init__(self, model: ALADIN, cfg: ExperimentConfig, loss_fn: Callable,
                 state: TrainState, batches: List[Batch], mesh: Optional[Mesh] = None):
        if not state.capturable:
            raise ValueError("a CUDA graph of the train step needs the capturable optimizer "
                             "(TrainState on the card)")
        self.n = len(batches)
        self.cfg = cfg
        device = batches[0].txt_ids.device
        self.inputs = [Batch(**{f: torch.empty_like(getattr(b, f)) for f in _FIELDS})
                       for b in batches]
        self.lrs = torch.zeros(self.n, dtype=torch.float32, device=device)
        self.gate = torch.zeros((), dtype=torch.float32, device=device)
        self.stream = torch.cuda.Stream(device)  # the warm-up's and the capture's
        step = state.step
        self._fill(state, batches, 0)
        saved = self._save(state, device)
        self.stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self.stream):
            _update(model, loss_fn, state, self.inputs[0], 0, self.lrs[0], self.gate, mesh)
        torch.cuda.current_stream(device).wait_stream(self.stream)
        self._restore(state, saved, device)

        self.graph = torch.cuda.CUDAGraph()
        state.optimizer.zero_grad(set_to_none=True)  # the captured steps' grads live in the pool
        try:
            with torch.cuda.graph(self.graph, stream=self.stream):
                rows = [_update(model, loss_fn, state, self.inputs[i], 0, self.lrs[i], self.gate,
                                mesh) for i in range(self.n)]
                self.names = list(rows[0])
                # the window's metrics, stacked as lax.scan stacks them
                self.metrics = torch.stack([torch.stack([r[k].float() for r in rows])
                                            for k in self.names])
        except RuntimeError as e:
            if mesh is None:
                raise
            raise RuntimeError(f"the data-parallel train window could not be captured as one "
                               f"CUDA graph with its NCCL collectives ({e}); run with "
                               f"--steps_per_dispatch 1") from e
        state.step = step

    def _fill(self, state: TrainState, batches: List[Batch], epoch: int) -> None:
        """Copy the batches, the learning rates and the gate into the
        graph's buffers on the current stream."""
        for buf, b in zip(self.inputs, batches):
            for f in _FIELDS:
                dst, src = getattr(buf, f), getattr(b, f)
                if dst.shape != src.shape:  # copy_ would broadcast a smaller batch
                    raise ValueError(f"batch field {f} is {tuple(src.shape)}; this graph was "
                                     f"captured for {tuple(dst.shape)}")
                dst.copy_(src, non_blocking=True)
        lrs = torch.tensor([state.schedule(state.schedule_step + i) for i in range(self.n)],
                           dtype=torch.float32).pin_memory()
        self.lrs.copy_(lrs, non_blocking=True)
        self.gate.fill_(float(epoch >= self.cfg.training.activate_distillation_after))

    @staticmethod
    def _save(state: TrainState, device):
        with torch.no_grad():
            params = [p.detach().clone() for p in state.trainable]
            moments = {p: {k: v.clone() for k, v in st.items()}
                       for p, st in state.optimizer.state.items()}
        return params, moments, torch.cuda.get_rng_state(device)

    @staticmethod
    def _restore(state: TrainState, saved, device) -> None:
        params, moments, rng = saved
        with torch.no_grad():
            for p, v in zip(state.trainable, params):
                p.copy_(v)
            for p, st in state.optimizer.state.items():
                for k, v in st.items():
                    if p in moments:
                        v.copy_(moments[p][k])
                    else:
                        v.zero_()
        torch.cuda.set_rng_state(rng, device)
        state.optimizer.zero_grad(set_to_none=True)

    def replay(self, state: TrainState, batches: List[Batch],
               epoch: int) -> Dict[str, torch.Tensor]:
        if len(batches) != self.n:
            raise ValueError(f"this graph runs windows of {self.n} batches, got {len(batches)}")
        self._fill(state, batches, epoch)
        self.graph.replay()
        state.step += self.n
        out = self.metrics.clone()  # the graph overwrites its slots on the next replay
        return {k: out[i] for i, k in enumerate(self.names)}


def make_eval_step(model: ALADIN, compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """Deterministic forward without gradients -> AladinOutputs."""

    def eval_step(batch: Batch):
        model.eval()
        with torch.inference_mode(), compute_autocast(batch.txt_ids.device, compute_dtype):
            return model(batch)

    return eval_step
