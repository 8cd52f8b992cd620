"""The port's tracing: spans and counters inside the program, the
``--profile_dir`` trace, and the train step's FLOPs accounting.

``span(name)`` names a stretch of host code in a ``torch.profiler`` trace:
while a profiler records it is a ``record_function`` (a ``user_annotation``
event in the same session, and so on the same clock, as the device's
records); otherwise it is one shared no-op context, a flag check and no
call into the dispatcher. ``count(name, n)`` adds to a process-wide
counter, and also to a traced tally while a profiler records;
``counters(traced)`` reads either, ``reset_counters(traced)`` clears it.
The kernel wrappers count their launches here, one counter a kernel named
by the ids of PERF.md's kernel table (``k1.launches``,
``k2.fwd_launches``, ...).

``Trace`` records a trace (the CPU and, on the card, the CUDA activity)
and writes it as a Chrome trace, ``<log_dir>/trace.json`` (Perfetto or
chrome://tracing open it); the Trainer records ``--profile_steps`` steps of
the first epoch with it (``--profile_dir``). torch.profiler on the card
loses the first device records of a trace, more with every trace a process
takes, so on the card a trace opens with ``PAD`` spin kernels, and ``stop``
logs how many of them were kept: whatever was lost lies in the pad.

``train_step_model_flops`` / ``transformer_layer_flops`` are aladin_tpu's
pure functions, copied; divide by a step's seconds and
``H100_SXM_BF16_DENSE_PEAK`` for the model FLOPs utilisation on the card.

aladin_tpu's ``utils/rng.py`` (its choice of dropout PRNG) has no
counterpart: torch's dropout on the card is Philox already, graph-safe, and
the fused attention kernel hashes a seed drawn from the same generator.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
from typing import Dict, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled

H100_SXM_BF16_DENSE_PEAK = 989e12  # FLOP/s, NVIDIA's data sheet, dense bf16 at 700 W
PAD = 512  # spin kernels that open a trace on the card
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_counts: Dict[str, int] = collections.Counter()
_traced: Dict[str, int] = collections.Counter()


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else a shared
    no-op context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to its traced tally while a
    profiler records."""
    with _lock:
        _counts[name] += n
        if _profiler_enabled():
            _traced[name] += n


def counters(traced: bool = False) -> Dict[str, int]:
    """A copy of the cumulative counters, or of the traced tally; a name
    never counted reads 0."""
    with _lock:
        return collections.Counter(_traced if traced else _counts)


def reset_counters(traced: bool = True) -> None:
    """Clear the traced tally (or, with ``traced=False``, the cumulative
    counters)."""
    with _lock:
        (_traced if traced else _counts).clear()


class Trace:
    """A ``torch.profiler`` capture: ``start()`` clears the traced
    counters and, on the card, queues the pad; ``stop()`` writes
    ``<log_dir>/trace.json`` and returns its path and the traced
    counters."""

    def __init__(self, log_dir: str, cuda: Optional[bool] = None):
        from torch.profiler import ProfilerActivity, profile

        self.log_dir = log_dir
        cuda = torch.cuda.is_available() if cuda is None else cuda
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._cuda = cuda
        self._prof = profile(activities=activities)

    def start(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()
        reset_counters(traced=True)
        self._prof.start()
        if self._cuda:
            for _ in range(PAD):
                torch.cuda._sleep(20_000)  # cycles
            torch.cuda.synchronize()

    def stop(self) -> Tuple[str, Dict[str, int]]:
        if self._cuda:
            torch.cuda.synchronize()  # the queued work ends inside the trace
        self._prof.stop()
        traced = counters(traced=True)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        if self._cuda:
            from torch.autograd import DeviceType

            kept = sum(e.count for e in self._prof.key_averages()
                       if e.device_type == DeviceType.CUDA and PAD_KERNEL in e.key)
            log = logging.getLogger("vlpretrain")
            if kept:
                log.info(f"trace pad: {kept} of {PAD} spin kernels kept")
            else:
                log.warning(f"trace pad: none of {PAD} spin kernels kept; the trace may have "
                            f"lost the first records of the steps")
        return path, traced


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
