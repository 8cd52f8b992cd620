#!/usr/bin/env python3
"""The flagship eager train step at B 128 of one tree on one CUDA card: its
card ms a step (torch.profiler's device time), its host-clock ms a step, and
whether two runs of 4 steps from one state repeat themselves bit for bit.

    python3 tools/step_repeat_ab.py [--root TREE] [--label NAME]

``--root`` is a checkout of the repository whose ``aladin_torch`` runs (by
default the one beside this script). Running two trees in turns, each in a
process of its own (A, B, B, A), compares them on one host.

The step is ``chip_smoke.py``'s ``train_graph`` configuration: the flagship
recipe at VinVL-base width with fused_attention and fused_layernorm,
dropout 0, random weights and batches from a seed (B 128 x 50 = 6400 token
ids, past the 3072 at which PyTorch's embedding backward sums with
atomics). Prints one JSON line, then the card's name and power limit.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("step_repeat_ab.py needs a CUDA device", file=sys.stderr)
        return 2
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.models.aladin import ALADIN, Batch
    from aladin_torch.models.bert_img import BertImgConfig
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_train_step
    from train_step_ab import synth_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(root, "aladin_torch", "configs", RECIPE)) as f:
        recipe = json.load(f)
    recipe["training"]["bs"] = 128
    recipe["model"]["dropout"] = 0.0
    cfg = ExperimentConfig.from_dict(recipe)

    def build():
        bert = BertImgConfig(fused_attention=True, fused_layernorm=True,
                             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        model = ALADIN(cfg, bert)
        model.reset_parameters(torch.Generator().manual_seed(4321))
        model = model.cuda().train()
        return TrainState(cfg, model, steps_per_epoch=100), make_train_step(
            model, cfg, torch.bfloat16)

    batches = [synth_batch(torch, Batch, 128, seed=10 + i) for i in range(4)]

    def four_steps():
        state, step = build()
        losses = [step(state, x, 0)["loss"] for x in batches]
        return state, step, torch.stack(losses), [p.detach().clone() for p in state.trainable]

    state, step, loss_a, params_a = four_steps()
    _, _, loss_b, params_b = four_steps()
    repeats = torch.equal(loss_a, loss_b) and all(
        torch.equal(p, q) for p, q in zip(params_a, params_b))
    differing = sum(not torch.equal(p, q) for p, q in zip(params_a, params_b))
    del params_a, params_b

    host = []
    for x in batches + batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, x, 0)
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x in batches:
            step(state, x, 0)
        torch.cuda.synchronize()
    card = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3 / len(batches)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "root": root, "batch": 128,
                      "repeats_bitwise": bool(repeats), "params_differing": differing,
                      "card_ms_per_step": card, "host_ms_per_step": sorted(host)[len(host) // 2],
                      "host_ms": host}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
