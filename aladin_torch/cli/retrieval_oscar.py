"""Legacy OSCAR retrieval CLI (mirrors aladin_tpu/cli/retrieval_oscar.py),
the ``oscar/run_retrieval.py`` equivalent.

Reference capability (ref:oscar/run_retrieval.py:316-664): train the joint
(caption, image) pair classifier with in-dataset random negative sampling,
then evaluate by scoring the full N x N pair product (cross_image_eval) and
computing ranks from the matched-pair probabilities. This is the entangled
baseline ALADIN distills from - quadratic at retrieval time, which is the
paper's motivation for the disentangled heads.

    python -m aladin_torch.cli.retrieval_oscar --data_dir <dir> --eval_model_dir <vocab dir> \\
        [--device cuda]

``--synthetic`` writes the 8-image retrieval corpus and builds a tiny model
(``--device cpu`` runs it without a card):

    python -m aladin_torch.cli.retrieval_oscar --synthetic --device cpu --epochs 1

Training is f32 with the kernel knobs off, as aladin_tpu's CLI; the weights
are random from ``--seed``. Each anchor adds a positive and a negative pair,
so a batch holds 2 x ``--train_batch_size`` rows. ``eval_results.json`` in
``--output_dir`` holds the R@K, written by rank 0.

Data parallelism: ``torchrun --nproc_per_node N -m
aladin_torch.cli.retrieval_oscar --mesh_shape dp=N ...``: every rank draws
the same pairs (one RandomState) and trains on its rows of each batch, with
the global batch's loss; every rank evaluates every pair.

``run(argv)`` returns {"model", "step", "batch" (its last inputs),
"metrics" (each step's loss and acc), "results"}; ``main`` returns 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from aladin_torch.cli.common import (add_device_flag, add_hidden_act_flag, build_tokenizer,
                                     prepare_synthetic)
from aladin_torch.cli.pretrain import data_parallel, make_optimizer
from aladin_torch.config import DataArgs
from aladin_torch.data.dataset import RetrievalDataset
from aladin_torch.models.bert_img import BertImgConfig, ImageBertClassifier, init_weights
from aladin_torch.parallel import distributed
from aladin_torch.tasks.retrieval_oscar import evaluate_cross, make_pair_train_step, sample_pairs
from aladin_torch.utils.device import resolve_device


def _parse(argv):
    p = argparse.ArgumentParser(description="OSCAR pair retrieval (PyTorch)")
    p.add_argument("--data_dir", default="datasets/coco_ir")
    p.add_argument("--img_feat_file", default="")
    p.add_argument("--eval_model_dir", default="")
    p.add_argument("--output_dir", default="output/retrieval_oscar")
    p.add_argument("--max_seq_length", type=int, default=70)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--img_feature_dim", type=int, default=2054)
    add_hidden_act_flag(p)
    p.add_argument("--train_batch_size", type=int, default=16,
                   help="anchor count; each anchor adds a positive + a negative")
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--loss_type", choices=("ce", "bce"), default="ce")
    p.add_argument("--eval_chunk", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mesh_shape", default="dp=-1",
                   help="dp=N under torchrun (one process a GPU); dp=-1 = every rank")
    p.add_argument("--synthetic", action="store_true")
    add_device_flag(p)
    return p.parse_args(argv)


def run(argv=None) -> Dict[str, Any]:
    ns = _parse(argv)
    device = resolve_device(ns.device)
    distributed.initialize(device=device.type)
    logger = distributed.rank_logger(ns.output_dir)

    # the retrieval DataArgs plumbing for files and tensorizer settings
    args = DataArgs(
        data_dir=ns.data_dir,
        img_feat_file=ns.img_feat_file or os.path.join(ns.data_dir, "features.tsv"),
        eval_model_dir=ns.eval_model_dir, output_dir=ns.output_dir,
        max_seq_length=ns.max_seq_length, max_img_seq_length=ns.max_img_seq_length,
        img_feature_dim=ns.img_feature_dim, add_od_labels=True, synthetic=ns.synthetic,
        seed=ns.seed)
    if ns.synthetic:
        args = prepare_synthetic(args)
    tokenizer = build_tokenizer(args)
    train_ds = RetrievalDataset(tokenizer, args, "train", is_train=True)
    test_ds = RetrievalDataset(tokenizer, args, "test", is_train=False)
    logger.info(f"train pairs/epoch: {2 * len(train_ds)}  test images: {len(test_ds.img_keys)}")

    if ns.synthetic:
        cfg = BertImgConfig(hidden_act=ns.hidden_act, vocab_size=tokenizer.vocab_size,
                            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=128, max_position_embeddings=256,
                            img_feature_dim=ns.img_feature_dim, num_labels=2)
    else:
        cfg = BertImgConfig(hidden_act=ns.hidden_act, vocab_size=tokenizer.vocab_size,
                            img_feature_dim=ns.img_feature_dim, num_labels=2)
    model = ImageBertClassifier(cfg)
    init_weights(model, torch.Generator().manual_seed(ns.seed), cfg.initializer_range)
    model.bert.seed_generator.manual_seed(ns.seed)
    torch.manual_seed(ns.seed)
    model.to(device)

    rng = np.random.RandomState(ns.seed)
    bs = min(ns.train_batch_size, len(train_ds))
    # aladin_tpu initializes its parameters from one sampled batch: the same
    # draws keep every later batch the same in both packages
    sample_pairs(train_ds, list(range(bs)), rng)
    # each anchor contributes a positive and a negative pair -> 2 * bs rows
    mesh, rows = data_parallel(model, ns.mesh_shape, 2 * bs, ns.seed, device)
    steps_per_epoch = max(len(train_ds) // bs, 1)
    optimizer, _ = make_optimizer(model, ns.learning_rate, ns.warmup_steps,
                                  ns.epochs * steps_per_epoch)
    step = make_pair_train_step(model, optimizer, ns.loss_type, mesh=mesh)

    metrics, batch = [], None
    for epoch in range(ns.epochs):
        t0, window = time.time(), []
        order = rng.permutation(len(train_ds))
        for i in range(steps_per_epoch):
            glob = sample_pairs(train_ds, order[i * bs: (i + 1) * bs], rng)
            batch = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(device) for a in glob]
            window.append(step(*batch))
        vals = [{k: v.item() for k, v in m.items()} for m in window]
        metrics += vals
        logger.info(f"epoch {epoch} loss {np.mean([m['loss'] for m in vals]):.4f} "
                    f"pair-acc {np.mean([m['acc'] for m in vals]):.3f} "
                    f"({time.time() - t0:.1f}s)")

    logger.info("cross_image_eval (N x N pair scoring)...")
    res = evaluate_cross(model, test_ds, chunk=ns.eval_chunk)
    logger.info("retrieval: " + " ".join(f"{k} {v:.2f}" for k, v in res.items()))
    if distributed.is_main_process():
        os.makedirs(ns.output_dir, exist_ok=True)
        with open(os.path.join(ns.output_dir, "eval_results.json"), "w") as f:
            json.dump(res, f, indent=2)
    distributed.barrier("retrieval_oscar_outputs")
    return {"model": model, "step": step, "batch": batch, "metrics": metrics, "results": res}


def main(argv=None) -> int:
    run(argv)
    gc.collect()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
