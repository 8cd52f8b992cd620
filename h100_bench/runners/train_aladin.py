"""Training: the port's ALADIN step as ``cli/train --steps_per_dispatch K``
runs it, ``train/step.py::make_multi_train_step`` (on the card one CUDA
graph of K steps, ``CapturedWindow``; a call with fewer batches runs them
as single steps).

Set-up builds the model on the device, loads the benchmark's weights
(``lib/weights.py``) and makes a pool of batches on the device
(``lib/inputs.py::aladin_batches``). Dropout runs at the recipe's rates:
right before step 1 the generators that the program draws its masks from
are seeded from the run's seed (``reference/dropout.py``). Then it drives
that one state through the window's own call: step 1 on the pool's first
batch alone (the call runs a shorter window as single steps), reading
Adam's state after it; then the first window of K batches, which captures the graph and replays
it (steps 2 to K + 1), reading the losses and the weights after it. A unit
is one window of K batches from the rest of the pool; it reads back the
previous window's losses, as a trainer logs them, so the host stays one
window ahead at most.

The check, after the measured window, against the plain reference
(``reference/aladin.py``, float32) following steps 1 to K + 1 on the same
batches and the same dropout masks:
  * ``loss_gap``: the larger relative gap of the losses of step 1 and of
    step 2, the graph's first;
  * ``grad_gap``: over the leaves, the largest gap between the norms of
    the program's first gradient as Adam got it (its first moment after
    step 1 over 1 - beta1) and the reference's, relative to the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; ``change_gap``: the same for each leaf's change after the
    first window (step K + 1), and ``change_diff_median`` the median leaf's
    norm of the difference of the two changes, relative as above: these
    two and step 2's loss hold the graph's own steps, which the window
    replays (the first gradient comes from step 1, a single step);
  * ``grad_diff`` / ``grad_diff_median``: the largest and the median, over
    the leaves, of the norm of the difference of the two first gradients,
    relative as above. Both swing on the odd seed (a hardest negative
    that flips on rounding moves many leaves); the worst leaf's is the
    number the float8 control fails.
Leaves whose first gradient in the reference is under a thousandth of the
median leaf's (rounding alone moves them under Adam) are left out.
``PERF.md`` gives the readings that set each limit.
"""

from __future__ import annotations

import gc
import statistics

import torch

from h100_bench.lib import bounds, inputs
from h100_bench.lib import weights as W
from h100_bench.lib.trace import span
from h100_bench.lib.traffic import stream_seed
from h100_bench.reference import aladin as ref
from h100_bench.reference.precision import Precision

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
QUIET_LEAF = 1e-3  # a leaf's first gradient under this share of the median leaf's: left out
LOSS_STEPS = 2  # step 1 (a single step) and step 2 (the first graph replay's first)


def port_configs(c: dict):
    """(ExperimentConfig, BertImgConfig) of the configuration file."""
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.models.bert_img import BertImgConfig

    recipe = {
        "dataset": {"name": "coco"},
        "model": {"name": "teran", "embed-size": c["hidden_size"], "text-aggregation": "first",
                  "image-aggregation": "first", "freeze-teran": False, "teran-layers": 0,
                  "tern-layers": c["tern_layers"], "post-layers": 0, "shared-transformer": True,
                  "depth-aggregation-alignment": False, "depth-aggregation-matching": False,
                  "dropout": c["matching_dropout"]},
        "training": {"lr": c["lr"], "grad-clip": c["grad_clip"], "max-violation": c["max_violation"],
                     "loss-type": c["loss_type"], "loss-weights": c["loss_weights"],
                     "alignment-mode": c["alignment_mode"],
                     "distillation-mode": c["distillation_mode"], "measure": c["measure"],
                     "margin": c["margin"], "bs": c["bs"], "scheduler": "steplr", "gamma": 0.1,
                     "step-size": 15, "warmup": None, "activate-distillation-after": 0}}
    keys = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
            "intermediate_size", "hidden_act", "max_position_embeddings", "type_vocab_size",
            "layer_norm_eps", "initializer_range", "img_feature_dim", "fused_attention",
            "fused_layernorm")
    bert = BertImgConfig(**{k: c[k] for k in keys}, hidden_dropout_prob=c["residual_dropout"],
                         attention_probs_dropout_prob=c["attention_dropout"])
    return ExperimentConfig.from_dict(recipe), bert


def seed_dropout(model, seed: int, device) -> None:
    """Seed the generators that ``model``'s training step draws its
    dropout from: the default CUDA generator on the card; on the CPU the
    default generator and the backbone's own one for the fused attention's
    seeds."""
    if torch.device(device).type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)
        model.oscar_model.bert.seed_generator.manual_seed(seed)


def reference_settings(c: dict) -> dict:
    return dict(c, adam_beta1=c["adam_betas"][0], adam_beta2=c["adam_betas"][1])


def pool_batches(c: dict, tr: dict, seed: int, device) -> list:
    """The pool: step 1's batch, then ``pool_windows`` windows of K."""
    return inputs.aladin_batches(c, tr, seed, device, 1 + tr["pool_windows"] * c["steps_per_dispatch"])


def check_batches(c: dict, tr: dict, seed: int, device) -> list:
    """The batches of steps 1 to K + 1: step 1's and the first window's."""
    return pool_batches(c, tr, seed, device)[:1 + c["steps_per_dispatch"]]


class Training:
    def __init__(self, ctx):
        from aladin_torch.models.aladin import ALADIN, Batch
        from aladin_torch.train import step as train_step
        from aladin_torch.train.state import TrainState

        c, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx, self.k, self.b = ctx, c["steps_per_dispatch"], c["bs"]
        exp, bert_cfg = port_configs(c)
        with torch.device(dev):
            model = ALADIN(exp, bert_cfg)
        w0 = W.make(ref.spec(c), ctx.seed, inputs.S_WEIGHTS, dev, c["initializer_range"])
        model.load_state_dict(w0, strict=True)
        model.train()
        self.model = model
        self.state = TrainState(exp, model, steps_per_epoch=1 << 40)
        self.step = train_step.make_multi_train_step(model, exp, DTYPES[c["compute_dtype"]], self.k)
        pool = [Batch(**b) for b in pool_batches(c, tr, ctx.seed, dev)]
        self.windows = [pool[i:i + self.k] for i in range(1, len(pool), self.k)]
        names = dict(model.named_parameters())
        b1 = c["adam_betas"][0]
        seed_dropout(model, stream_seed(ctx.seed, inputs.S_DROPOUT), dev)
        with span("train.single_step"):
            losses = [float(self.step(self.state, pool[:1], 0)["loss"][0])]
        grads = {}  # the host keeps them until the check
        for n, p in names.items():
            st = self.state.optimizer.state.get(p, {})
            if "exp_avg" in st:
                grads[n] = (st["exp_avg"].float() / (1 - b1)).cpu()
        with span("train.window"):
            first = self.step(self.state, self.windows[0], 0)
        losses.append(float(first["loss"][0]))
        change = {n: (p.detach().float() - w0[n].float()).cpu() for n, p in names.items()}
        del w0
        self.first = {"losses": losses, "grad": grads, "change": change}
        self.next, self.pending = 1, None
        self.layers = c["num_hidden_layers"]

    def unit(self) -> int:
        batches = self.windows[self.next]
        self.next = self.next % (len(self.windows) - 1) + 1
        with span("train.window"):
            metrics = self.step(self.state, batches, 0)
        if self.pending is not None:
            with span("train.read_loss"):
                self.pending.cpu()
        self.pending = metrics["loss"]
        return self.k * self.b

    def drain(self) -> None:
        if self.pending is not None:
            self.pending.cpu()

    def counters(self) -> dict:
        c = self.ctx.config
        lt, r, h = c["max_seq_length"], c["max_img_seq_length"], c["hidden_size"]
        heads = c["num_attention_heads"]
        k2 = 0.0
        for s in (lt, lt + r):
            for backward in (False, True):
                k2 += bounds.attention_bound(self.b, s, heads, h // heads, 1, backward)[0]
        return {"steps_per_unit": self.k,
                "model_flops_per_step": bounds.train_step_model_flops(
                    self.b, lt, lt, r, h, self.layers, c["intermediate_size"],
                    c["img_feature_dim"], c["tern_layers"]),
                "k2_bound_s_per_step": self.layers * k2}

    def failed(self) -> int:
        return 0

    def release(self) -> None:
        if self.step is not None:
            self.step.window = None  # the CUDA graph, freed here and not during a later capture
        self.model = self.state = self.step = self.windows = self.pending = None
        gc.collect()

    def check(self):
        c, ctx = reference_settings(self.ctx.config), self.ctx
        w0 = W.make(ref.spec(c), ctx.seed, inputs.S_WEIGHTS, ctx.device, c["initializer_range"])
        batches = check_batches(c, ctx.traffic, ctx.seed, ctx.device)
        want = ref.train(w0, batches, c, Precision("f32"), len(batches),
                         stream_seed(ctx.seed, inputs.S_DROPOUT))
        return compare(self.first, want, ctx.traffic["limits"])


def control(work: Training) -> dict:
    """Readings of the check's numbers for the control (the reference
    with float8 products in the program's place) and for a planted fault
    (half of each batch left out), each against the float32 reference."""
    c, ctx = reference_settings(work.ctx.config), work.ctx
    w0 = W.make(ref.spec(c), ctx.seed, inputs.S_WEIGHTS, ctx.device, c["initializer_range"])
    batches = check_batches(c, ctx.traffic, ctx.seed, ctx.device)
    n, seed = len(batches), stream_seed(ctx.seed, inputs.S_DROPOUT)
    want = ref.train(w0, batches, c, Precision("f32"), n, seed)
    half = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    lim = ctx.traffic["limits"]
    return {"fp8": compare(ref.train(w0, batches, c, Precision("fp8"), n, seed), want, lim),
            "half_batch": compare(ref.train(w0, half, c, Precision("f32"), n, seed), want, lim)}


def leaf_gaps(prog: dict, want: dict, keep) -> tuple:
    """Over the kept leaves, the largest gap between the program's norm
    and the reference's, and the largest and the median norm of their
    difference, each relative to the leaf's reference norm or the median
    kept leaf's, whichever is larger. A leaf missing on the program's side
    counts as zero."""
    norms = {n: float(want[n].norm()) for n in keep}
    median = statistics.median(norms.values())
    gaps, diffs = [], []
    for n in keep:
        w = want[n]
        p = prog[n].to(w.device) if n in prog else torch.zeros_like(w)
        scale = max(norms[n], median)
        gaps.append(abs(float(p.norm()) - norms[n]) / scale)
        diffs.append(float((p - w).norm()) / scale)
    return max(gaps), max(diffs), statistics.median(diffs)


def readings(prog: dict, want: dict) -> dict:
    """Every candidate number of the training check."""
    median = statistics.median(want["raw_grad_norm"].values())
    keep = [n for n, g in want["raw_grad_norm"].items() if g >= QUIET_LEAF * median]
    out = {"loss_gap": max(abs(p - w) / abs(w) for p, w in
                           zip(prog["losses"][:LOSS_STEPS], want["losses"][:LOSS_STEPS]))}
    out["grad_gap"], out["grad_diff"], out["grad_diff_median"] = leaf_gaps(
        prog["grad"], want["grad"], keep)
    out["change_gap"], _, out["change_diff_median"] = leaf_gaps(prog["change"], want["change"],
                                                                keep)
    return out


def compare(prog: dict, want: dict, limits: dict):
    """[(name, value, limit)] of the numbers that ``limits`` names."""
    r = readings(prog, want)
    return [(name, r[name], limit) for name, limit in limits.items()]


def setup(ctx) -> Training:
    return Training(ctx)
