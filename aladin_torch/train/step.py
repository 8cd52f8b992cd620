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
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

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
    """(aux params, batch, epoch) -> (total loss, {name_loss: term, loss}).
    The forward runs under autocast to ``compute_dtype``; the losses take
    its f32 outputs and stay in f32."""
    tc = cfg.training
    types = tc.loss_types
    if tc.encoder_microbatch:
        raise NotImplementedError("encoder-microbatch (the B >= 1024 memory lever) is not ported "
                                  "yet (ROADMAP.md, queue 1, item 4)")

    def loss_fn(aux: Dict[str, torch.Tensor], batch: Batch, epoch: int):
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
            gates["distillation"] = float(epoch >= tc.activate_distillation_after)
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


def make_train_step(model: ALADIN, cfg: ExperimentConfig,
                    compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """(state, batch, epoch) -> metrics: one update of ``state`` in place;
    metrics are detached device scalars, ``grad_norm`` (over every
    gradient, before the clip) included."""
    loss_fn = make_loss_fn(model, cfg, compute_dtype)

    def train_step(state: TrainState, batch: Batch, epoch: int) -> Dict[str, torch.Tensor]:
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        for p in state.frozen:
            p.grad = None
        total, metrics = loss_fn(state.aux, batch, epoch)
        total.backward()
        metrics["grad_norm"] = global_norm([p.grad for p in state.parameters()
                                            if p.grad is not None])
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model: ALADIN, compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """Deterministic forward without gradients -> AladinOutputs."""

    def eval_step(batch: Batch):
        model.eval()
        with torch.inference_mode(), _autocast(batch.txt_ids.device, compute_dtype):
            return model(batch)

    return eval_step
