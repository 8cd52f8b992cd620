#!/usr/bin/env python3
"""Time the eager flagship train step (``make_train_step``, the K 1 default
of ``cli/train``) of one tree on one CUDA card, with the state's own
optimizer and with torch's non-capturable Adam (a float lr) in its place.

    python3 tools/train_step_ab.py [--root TREE] [--label NAME] [--steps N]

``--root`` is a checkout of the repository whose ``aladin_torch`` is timed
(by default the one beside this script). Timing two trees in turns, each in
a process of its own (A, B, B, A), compares them on one host.

The step is the flagship recipe at VinVL-base width with fused_attention
and fused_layernorm on, at the recipe's bs 32 and at B 128, dropout 0 and
0.1, random weights and batches from a seed (``chip_smoke.py``'s
``train_fused`` configuration). For each, two states from the same weights
(own optimizer, torch's Adam) take 2 warm-up steps, then ``N`` steps each
in turns (own, plain, plain, own); every step is followed by a
synchronize, and its host-clock time is kept. Prints one JSON line a
configuration, then one with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = "alad-alignment-and-matching-distill.json"


def synth_batch(torch, Batch, b: int, l: int = 50, r: int = 34, feat_dim: int = 2054,
                vocab: int = 30522, seed: int = 5):
    """A random disentangled batch on the card (chip_smoke.py's)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

    cap_len, img_len, lab_len = ints(8, l + 1, (b,)), ints(4, r + 1, (b,)), ints(4, l + 1, (b,))
    pos_l, pos_r = torch.arange(l, device="cuda")[None], torch.arange(r, device="cuda")[None]
    return Batch(
        txt_ids=ints(3, vocab, (b, l)), txt_mask=(pos_l < cap_len[:, None]).int(),
        txt_type=torch.zeros(b, l, dtype=torch.int32, device="cuda"), cap_len=cap_len,
        img_ids=ints(3, vocab, (b, l)),
        img_mask=torch.cat([pos_l < lab_len[:, None], pos_r < img_len[:, None]], dim=1).int(),
        img_type=torch.ones(b, l, dtype=torch.int32, device="cuda"),
        img_feats=torch.randn(b, r, feat_dim, generator=gen, device="cuda"), img_len=img_len)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("train_step_ab.py needs a CUDA device", file=sys.stderr)
        return 2
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.models.aladin import ALADIN, Batch
    from aladin_torch.models.bert_img import BertImgConfig
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_train_step

    with open(os.path.join(root, "aladin_torch", "configs", RECIPE)) as f:
        recipe = json.load(f)

    def build(b, dropout):
        recipe["training"]["bs"] = b
        recipe["model"]["dropout"] = dropout
        cfg = ExperimentConfig.from_dict(recipe)
        bert = BertImgConfig(fused_attention=True, fused_layernorm=True,
                             hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
        model = ALADIN(cfg, bert)
        model.reset_parameters(torch.Generator().manual_seed(4321))
        model = model.cuda().train()
        return model, TrainState(cfg, model, steps_per_epoch=100), make_train_step(
            model, cfg, torch.bfloat16)

    for b in (32, 128):
        batch = synth_batch(torch, Batch, b)
        for dropout in (0.0, 0.1):
            runs = {}
            for kind in ("own", "plain"):
                model, state, step = build(b, dropout)
                if kind == "plain":
                    state.optimizer = torch.optim.Adam(state.trainable, lr=state.schedule(0),
                                                       betas=(0.9, 0.999), eps=1e-8)
                    state.capturable = False
                runs[kind] = (state, step)
            capturable = bool(runs["own"][0].optimizer.param_groups[0]["capturable"])
            ms = {"own": [], "plain": []}
            for kind, n in (("own", 2), ("plain", 2), ("own", args.steps), ("plain", args.steps),
                            ("plain", args.steps), ("own", args.steps)):
                state, step = runs[kind]
                for i in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(state, batch, 0)
                    torch.cuda.synchronize()
                    if state.step > 2:  # past the warm-up steps
                        ms[kind].append(1e3 * (time.perf_counter() - t0))
            print(json.dumps({
                "label": args.label, "root": root, "batch": b, "dropout": dropout,
                "own_optimizer_capturable": capturable,
                "step_ms_mean": {k: sum(v) / len(v) for k, v in ms.items()},
                "step_ms": ms}), flush=True)
            del runs, model, state, step
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"label": args.label, "card": smi.stdout.strip(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
