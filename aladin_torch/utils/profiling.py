"""Profiling hooks and the train step's FLOPs accounting (mirrors
aladin_tpu/utils/profiling.py).

``Trace`` / ``trace(log_dir)`` record a ``torch.profiler`` trace (the CPU
and, on the card, the CUDA activity) and write it as a Chrome trace,
``<log_dir>/trace.json`` (Perfetto or chrome://tracing open it); the
Trainer records ``--profile_steps`` steps of the first epoch with it
(``--profile_dir``). ``annotate(name)`` names a span in it. ``StepTimer``
times on the host clock, waiting for the card when given a CUDA tensor.

``train_step_model_flops`` / ``transformer_layer_flops`` are aladin_tpu's
pure functions, copied; divide by a step's seconds and
``H100_SXM_BF16_DENSE_PEAK`` for the model FLOPs utilisation on the card.

aladin_tpu's ``utils/rng.py`` (its choice of dropout PRNG) has no
counterpart: torch's dropout on the card is Philox already, graph-safe, and
the fused attention kernel hashes a seed drawn from the same generator.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

H100_SXM_BF16_DENSE_PEAK = 989e12  # FLOP/s, NVIDIA's data sheet, dense bf16 at 700 W


class Trace:
    """A ``torch.profiler`` capture: ``start()``, then ``stop()`` writes
    ``<log_dir>/trace.json`` and returns its path."""

    def __init__(self, log_dir: str, cuda: Optional[bool] = None):
        from torch.profiler import ProfilerActivity, profile

        self.log_dir = log_dir
        cuda = torch.cuda.is_available() if cuda is None else cuda
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._cuda = cuda
        self._prof = profile(activities=activities)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> str:
        if self._cuda:
            torch.cuda.synchronize()  # the queued work ends inside the trace
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a trace of the block into ``<log_dir>/trace.json``."""
    t = Trace(log_dir)
    t.start()
    try:
        yield t
    finally:
        t.stop()


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        yield


def transformer_layer_flops(seq: int, d_model: int, d_ff: int) -> float:
    """Forward matmul FLOPs of one post-LN transformer encoder layer for one
    sequence (multiply-add = 2 FLOPs):

      QKV + output projections: 4 * 2*S*d^2
      attention scores + mixing: 2 * 2*S^2*d
      FFN (two matmuls):         2 * 2*S*d*d_ff

    Elementwise work (softmax, LN, gelu, bias) is omitted: it is bytes, not
    tensor-core FLOPs, and <2% of the total at these widths.
    """
    return 8 * seq * d_model**2 + 4 * seq**2 * d_model + 4 * seq * d_model * d_ff


def train_step_model_flops(
    batch: int,
    text_len: int = 50,
    img_text_len: int = 50,
    n_regions: int = 34,
    hidden: int = 768,
    n_layers: int = 12,
    intermediate: int = 3072,
    img_feature_dim: int = 2054,
    tern_layers: int = 2,
    alignment: bool = True,
) -> float:
    """Model FLOPs of one ALADIN train step (forward + backward, without any
    recompute: the usual MFU numerator), at the reference geometry (a dual
    disentangled 12-layer pass at max_seq_length 50 / max_img_seq_length 34).

    Accounting:
      * caption pass:  S = text_len tokens through n_layers BERT layers;
      * image pass:    S = img_text_len + n_regions tokens (OD-label text
        concatenated with region features) plus the img_embedding
        Linear(2054 -> 768) on the regions;
      * matching head: tern_layers transformer layers (d_ff = hidden) over
        both token sets;
      * alignment loss: the B^2 * R * W * d similarity tensor, R / W
        stripped of specials (-1 region, -3 words);
      * matching loss:  B^2 global dot products (negligible, included);
      * backward = 2x forward for every matmul (dL/dW and dL/dx GEMMs).

    Returns the FLOPs of the whole batch (divide by seconds for FLOP/s).
    """
    s_img = img_text_len + n_regions
    fwd = 0.0
    for s in (text_len, s_img):
        fwd += batch * n_layers * transformer_layer_flops(s, hidden, intermediate)
    fwd += batch * 2 * n_regions * img_feature_dim * hidden  # img projection
    # the matching head always runs, even alignment-only
    for s in (text_len, s_img):
        fwd += batch * tern_layers * transformer_layer_flops(s, hidden, hidden)
    if alignment:
        fwd += 2 * batch * batch * (n_regions - 1) * (text_len - 3) * hidden
    fwd += 2 * batch * batch * hidden  # global score matrix
    return 3.0 * fwd  # fwd + 2x bwd


class StepTimer:
    """Host-clock step timer; ``lap(t)`` waits for the card first when ``t``
    is a CUDA tensor, so the lap holds the work queued before it."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self, fetchable: Optional[torch.Tensor] = None) -> float:
        if fetchable is not None and fetchable.is_cuda:
            torch.cuda.synchronize(fetchable.device)
        now = time.perf_counter()
        dt, self.t0 = now - self.t0, now
        return dt
