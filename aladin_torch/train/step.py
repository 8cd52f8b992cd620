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

from aladin_torch.config import ExperimentConfig
from aladin_torch.models.aladin import ALADIN, Batch
from aladin_torch.ops import losses as L
from aladin_torch.train.state import TrainState, global_norm


def _autocast(device: torch.device, dtype: Optional[torch.dtype]):
    if dtype is None or dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def make_loss_fn(model: ALADIN, cfg: ExperimentConfig,
                 compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """(aux params, batch, epoch, distill_gate=None) -> (total loss,
    {name_loss: term, loss}). The forward runs under autocast to
    ``compute_dtype``; the losses take its f32 outputs and stay in f32.
    ``distill_gate``: a device scalar (1 or 0) that replaces the host's
    ``epoch >= activate-distillation-after``, so a CUDA graph reads the gate
    of the epoch it is replayed in."""
    tc = cfg.training
    types = tc.loss_types
    if tc.encoder_microbatch:
        raise NotImplementedError("encoder-microbatch (the B >= 1024 memory lever) is not ported "
                                  "yet (ROADMAP.md, queue 1, item 4)")

    def loss_fn(aux: Dict[str, torch.Tensor], batch: Batch, epoch: int,
                distill_gate: Optional[torch.Tensor] = None):
        with _autocast(batch.txt_ids.device, compute_dtype):
            out = model(batch)
        terms: Dict[str, torch.Tensor] = {}
        matching_loss, matching_mat = L.matching_loss(out.img_global, out.cap_global, tc.margin,
                                                      tc.measure, tc.max_violation)
        if "matching" in types:
            terms["matching"] = matching_loss
        teacher = None
        if "alignment" in types or "distillation" in types:
            alignment_loss, teacher = L.alignment_contrastive_loss(
                out.img_set, out.cap_seq, out.img_len, out.cap_len, tc.margin, tc.max_violation,
                tc.alignment_mode, normalized=True, chunk=tc.alignment_chunk)
            if "alignment" in types:
                terms["alignment"] = alignment_loss
        if "selfaggregation" in types:
            terms["selfaggregation"] = matching_loss
        if "distillation" in types:
            terms["distillation"] = L.distillation_loss(
                teacher.detach(), matching_mat, tc.distillation_mode, wb=aux.get("distill_wb"),
                margin=0.2)
        if "entropy" in types:
            terms["entropy"] = L.entropy_uniformity_loss(out.img_global, out.cap_global)
        if "regularizehidden" in types:
            terms["regularizehidden"] = out.l1_reg

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
            lr: Optional[torch.Tensor] = None,
            distill_gate: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The body of one step (see ``make_train_step``); ``lr`` and
    ``distill_gate``: device scalars a CUDA graph reads instead of the
    host's schedule value and epoch."""
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    for p in state.frozen:
        p.grad = None
    total, metrics = loss_fn(state.aux, batch, epoch, distill_gate)
    total.backward()
    metrics["grad_norm"] = global_norm([p.grad for p in state.parameters() if p.grad is not None])
    state.apply_gradients(lr)
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: ALADIN, cfg: ExperimentConfig,
                    compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """(state, batch, epoch) -> metrics: one update of ``state`` in place;
    metrics are detached device scalars, ``grad_norm`` (over every
    gradient, before the clip) included."""
    loss_fn = make_loss_fn(model, cfg, compute_dtype)

    def train_step(state: TrainState, batch: Batch, epoch: int) -> Dict[str, torch.Tensor]:
        return _update(model, loss_fn, state, batch, epoch)

    return train_step


def make_multi_train_step(model: ALADIN, cfg: ExperimentConfig,
                          compute_dtype: Optional[torch.dtype] = None,
                          k: int = 2) -> Callable:
    """(state, batches, epoch) -> metrics stacked (len(batches),): a window
    of up to ``k`` steps as one dispatch, equal to as many single steps
    (``make_train_step``) bit for bit.

    On the card, the first window of ``k`` batches is captured as one CUDA
    graph (``CapturedWindow``, kept as ``multi_step.window``) and every
    window of ``k`` replays it: the batches are copied into the graph's
    static buffers on the current stream, so they are ordered after the
    loader's copies, and the metrics come back as a copy of the graph's
    (k,) slots. A shorter window (an epoch's remainder) and every window on
    the CPU run as single steps, one after another."""
    if k < 1:
        raise ValueError(f"steps per dispatch must be >= 1, got {k}")
    single = make_train_step(model, cfg, compute_dtype)
    loss_fn = make_loss_fn(model, cfg, compute_dtype)

    def multi_step(state: TrainState, batches: List[Batch], epoch: int) -> Dict[str, torch.Tensor]:
        if not 1 <= len(batches) <= k:
            raise ValueError(f"a window holds 1..{k} batches, got {len(batches)}")
        if len(batches) < k or batches[0].txt_ids.device.type != "cuda":
            rows = [single(state, b, epoch) for b in batches]
            return {name: torch.stack([r[name] for r in rows]) for name in rows[0]}
        if multi_step.window is None:
            multi_step.window = CapturedWindow(model, cfg, loss_fn, state, batches)
        return multi_step.window.replay(state, batches, epoch)

    multi_step.window = None
    return multi_step


_FIELDS = tuple(f.name for f in dataclasses.fields(Batch))


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
    f32 instead of in bf16, and the window would not equal the eager steps."""

    def __init__(self, model: ALADIN, cfg: ExperimentConfig, loss_fn: Callable,
                 state: TrainState, batches: List[Batch]):
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
            _update(model, loss_fn, state, self.inputs[0], 0, self.lrs[0], self.gate)
        torch.cuda.current_stream(device).wait_stream(self.stream)
        self._restore(state, saved, device)

        self.graph = torch.cuda.CUDAGraph()
        state.optimizer.zero_grad(set_to_none=True)  # the captured steps' grads live in the pool
        with torch.cuda.graph(self.graph, stream=self.stream):
            rows = [_update(model, loss_fn, state, self.inputs[i], 0, self.lrs[i], self.gate)
                    for i in range(self.n)]
            self.names = list(rows[0])
            # the window's metrics, stacked as lax.scan stacks them
            self.metrics = torch.stack([torch.stack([r[k].float() for r in rows])
                                        for k in self.names])
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
        with torch.inference_mode(), _autocast(batch.txt_ids.device, compute_dtype):
            return model(batch)

    return eval_step
