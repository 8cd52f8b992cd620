#!/usr/bin/env python3
"""Data parallelism across the ranks of a torchrun launch: checks and step
times of aladin_torch's data-parallel training and sharded scoring.

    torchrun --nproc_per_node N tools/dp_check.py [--device cpu --small]

Every rank builds the same weights and global batches from a seed; rank r
trains on rows [r B / N, (r + 1) B / N) of each. On every rank:

  1. ``sharded_mrsw_scores`` without the small-corpus fallback against the
     unsharded ``mrsw_scores`` on the same inputs (on the card K1 in bf16,
     whose scores do not depend on the shape: bit for bit);
  2. one data-parallel step against the one-process step on the whole
     global batch, which every rank also runs: loss, grad_norm and the
     parameters after the step (bf16 on the card: the GEMMs of B / N rows
     round differently from those of B, so they agree to within rounding);
  3. a CUDA graph of K data-parallel steps, the NCCL collectives captured,
     against K eager ones from the same state, bit for bit (on the CPU the
     window runs eager steps);
  4. host-clock ms a step, each step closed by a synchronize: the
     data-parallel step at the global batch B eager and graphed, and the
     one-process step at B; and the ms of the gradient all-reduce alone
     (``train/step.py::average_gradients`` over the step's gradients).

The card's configuration is the flagship recipe at VinVL-base width (12
layers, hidden 768, 2054-d regions, text 50, regions 34) with the
fused_attention and fused_layernorm kernels, B 128, dropout 0; ``--small``
is a 2-layer, hidden-32 f32 model at B 8 without them, for a rehearsal. Rank 0
prints one JSON line (each difference summed over the ranks, a bound of
the largest), then on the card the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = "alad-alignment-and-matching-distill.json"
LOSS_RTOL = 1e-3  # the dp step's loss against the one-process step's (bf16 GEMM roundings)


def build(torch, small: bool, device, seed: int = 4321):
    """(cfg, ALADIN in train mode on ``device``) from a seed, dropout 0."""
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.models.aladin import ALADIN
    from aladin_torch.models.bert_img import BertImgConfig

    with open(os.path.join(HERE, "aladin_torch", "configs", RECIPE)) as f:
        recipe = json.load(f)
    recipe["model"]["dropout"] = 0.0
    if small:
        recipe["model"]["embed-size"] = 32
        recipe["training"]["bs"] = 8
        bert = BertImgConfig(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=64,
                             max_position_embeddings=64, img_feature_dim=20,
                             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    else:
        recipe["training"]["bs"] = 128
        bert = BertImgConfig(fused_attention=True, fused_layernorm=True,
                             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg = ExperimentConfig.from_dict(recipe)
    model = ALADIN(cfg, bert)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return cfg, model.to(device).train()


def batch(torch, b: int, small: bool, device, seed: int):
    """A random disentangled global batch, the same on every rank."""
    from aladin_torch.models.aladin import Batch

    l, r, feat, vocab = (16, 6, 20, 97) if small else (50, 34, 2054, 30522)
    gen = torch.Generator().manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    cap_len, img_len, lab_len = ints(5, l + 1, (b,)), ints(2, r + 1, (b,)), ints(2, l + 1, (b,))
    pos_l, pos_r = torch.arange(l)[None], torch.arange(r)[None]
    out = Batch(
        txt_ids=ints(3, vocab, (b, l)), txt_mask=(pos_l < cap_len[:, None]).int(),
        txt_type=torch.zeros(b, l, dtype=torch.int32), cap_len=cap_len,
        img_ids=ints(3, vocab, (b, l)),
        img_mask=torch.cat([pos_l < lab_len[:, None], pos_r < img_len[:, None]], dim=1).int(),
        img_type=torch.ones(b, l, dtype=torch.int32),
        img_feats=torch.randn(b, r, feat, generator=gen), img_len=img_len)
    return Batch(**{f: getattr(out, f).to(device) for f in Batch.__dataclass_fields__})


def rows(b, lo: int, hi: int):
    from aladin_torch.models.aladin import Batch

    return Batch(**{f: getattr(b, f)[lo:hi] for f in Batch.__dataclass_fields__})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true",
                    help="a tiny f32 model at B 8, without the kernel knobs (a rehearsal)")
    ap.add_argument("--k", type=int, default=4, help="steps in the CUDA graph's window")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    from aladin_torch.parallel.distributed import initialize, shutdown
    from aladin_torch.parallel.mesh import create_mesh

    if args.device == "cuda" and not torch.cuda.is_available():
        print("dp_check.py --device cuda needs a CUDA device", file=sys.stderr)
        return 2
    initialize(device=args.device)
    try:
        ok = checks(args, create_mesh("dp=-1"))
    finally:
        gc.collect()  # the checks' CUDA graphs go before the NCCL communicator
        shutdown()
    return 0 if ok else 1


def checks(args, mesh) -> bool:
    """Run the checks on this rank; rank 0 prints. True when they pass."""
    import torch

    from aladin_torch.ops.kernels.alignment_kernel import mrsw_scores
    from aladin_torch.parallel.distributed import all_reduce_metrics
    from aladin_torch.parallel.mesh import sharded_mrsw_scores
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import average_gradients, make_multi_train_step, make_train_step

    n, rank = mesh.size, mesh.rank
    device = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = None if args.small else torch.bfloat16

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def host_ms(fn, reps: int) -> float:
        fn()  # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return 1e3 * (time.perf_counter() - t0) / reps

    out = {"ranks": n, "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}
    diffs = {}

    # 1. the sharded scorer against the unsharded one
    gen = torch.Generator().manual_seed(7)
    n_im, n_cap, r_im, w, d = (24, 300, 9, 12, 32) if args.small else (1000, 5000, 34, 50, 768)
    sc = [torch.randn(n_im, r_im, d, generator=gen), torch.randn(n_cap, w, d, generator=gen),
          torch.randint(5, r_im + 1, (n_im,), generator=gen),
          torch.randint(4, w + 1, (n_cap,), generator=gen)]
    sc = [x.to(device) for x in sc]
    got = sharded_mrsw_scores(mesh, *sc, use_kernel=True, small_corpus_fallback=False)
    want = mrsw_scores(*sc)
    diffs["sharded_mrsw_max_abs_diff"] = (got - want).abs().max().item()
    out["sharded_mrsw_bf16_bitwise"] = bool(torch.equal(got, want))

    # 2. the dp step against the one-process step on the whole global batch
    cfg, model = build(torch, args.small, device)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    b = cfg.training.bs
    per = b // n
    batches = [batch(torch, b, args.small, device, 10 + i) for i in range(args.k)]
    mine = [rows(x, rank * per, (rank + 1) * per) for x in batches]
    one = TrainState(cfg, model, steps_per_epoch=100)
    one_step = make_train_step(model, cfg, dtype)
    want = {k: v.item() for k, v in one_step(one, batches[0], 0).items()}
    _, dp_model = build(torch, args.small, device)
    dp_model.load_state_dict(start)
    dp = TrainState(cfg, dp_model, steps_per_epoch=100)
    dp_step = make_train_step(dp_model, cfg, dtype, mesh)
    got = {k: v.item() for k, v in dp_step(dp, mine[0], 0).items()}
    diffs["loss_rel_diff"] = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    diffs["grad_norm_rel_diff"] = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    diffs["param_max_abs_diff"] = max((p - q).abs().max().item()
                                      for p, q in zip(dp.trainable, one.trainable))
    out["one_process_loss"], out["dp_loss"] = want["loss"], got["loss"]

    # 3. a graphed window of K dp steps against K eager dp steps
    _, eager_model = build(torch, args.small, device)
    eager_model.load_state_dict(start)
    eager = TrainState(cfg, eager_model, steps_per_epoch=100)
    eager_step = make_train_step(eager_model, cfg, dtype, mesh)
    singles = [eager_step(eager, x, 0) for x in mine]
    _, graph_model = build(torch, args.small, device)
    graph_model.load_state_dict(start)
    graphed = TrainState(cfg, graph_model, steps_per_epoch=100)
    multi = make_multi_train_step(graph_model, cfg, dtype, k=args.k, mesh=mesh)
    window = multi(graphed, mine, 0)
    same = all(torch.equal(window[k], torch.stack([s[k] for s in singles])) for k in window)
    same = same and all(torch.equal(p, q) for p, q in zip(graphed.trainable, eager.trainable))
    out["graph_equals_eager_bitwise"] = bool(same)

    # 4. host ms a step
    out["host_ms_per_step"] = {
        f"dp_eager_B{b}": host_ms(lambda: eager_step(eager, mine[0], 0), 5),
        f"dp_graph_B{b}": host_ms(lambda: multi(graphed, mine, 0), 3) / args.k,
        f"one_process_B{b}": host_ms(lambda: one_step(one, batches[0], 0), 5)}
    grads = [p.grad for p in eager.parameters() if p.grad is not None]
    out["gradient_allreduce"] = {
        "ms": host_ms(lambda: average_gradients(mesh, grads), 5),
        "mbytes": 4e-6 * sum(g.numel() for g in grads)}
    worst = all_reduce_metrics(diffs, op="sum")
    flags = all_reduce_metrics({"bitwise": float(out["graph_equals_eager_bitwise"]),
                                "sharded": float(out["sharded_mrsw_bf16_bitwise"])}, op="sum")
    out["diffs_summed_over_ranks"] = worst
    out["graph_equals_eager_bitwise_ranks"] = int(flags["bitwise"])
    out["sharded_mrsw_bf16_bitwise_ranks"] = int(flags["sharded"])
    ok = (flags["bitwise"] == n and worst["loss_rel_diff"] <= n * LOSS_RTOL
          and (device.type != "cuda" or flags["sharded"] == n))
    out["ok"] = bool(ok)
    if rank == 0:
        print(json.dumps(out), flush=True)
        if device.type == "cuda":
            print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip(), flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
