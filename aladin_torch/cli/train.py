"""Training CLI (mirrors aladin_tpu/cli/train.py on one device).

    python -m aladin_torch.cli.train --config aladin_torch/configs/<recipe>.json \\
        --data_dir datasets/coco_ir --img_feat_file datasets/coco_ir/features.tsv \\
        --eval_model_dir <vinvl-checkpoint-dir> --add_od_labels \\
        --max_seq_length 50 --max_img_seq_length 34 --val_step 7000 \\
        --logger_name runs/<exp> [--device cuda]

Data parallelism: one process a GPU under ``torchrun``, each rank with
B / N rows of every global batch and the global batch's loss
(``train/step.py``); rank 0 logs and writes the checkpoints:

    torchrun --nproc_per_node N -m aladin_torch.cli.train --mesh_shape dp=N ...

Tensor parallelism on top: ``--mesh_shape dp=N,tp=M`` under ``torchrun
--nproc_per_node N*M`` shards the model's attention heads and FFN rows over
the M ranks of each dp group (Megatron, ``parallel/sharding.py``); each dp
group takes B / N rows, validation encodes with the sharded model and scores
over every rank, and the checkpoints hold the full tensors:

    torchrun --nproc_per_node 4 -m aladin_torch.cli.train --mesh_shape dp=2,tp=2 ...

``--mesh_shape dp=-1`` takes every rank; one rank runs without a mesh. A tp
that does not divide the backbone's or the heads' head counts raises.

``--synthetic`` builds a tiny on-disk dataset and a small random backbone
and runs the whole loop (``--device cpu`` runs it without a card).
``--steps_per_dispatch K`` runs K steps a dispatch (one CUDA graph replay on
the card; the same result as K single steps) and ``--profile_dir`` writes a
``torch.profiler`` trace of ``--profile_steps`` steps. The
model keeps f32 parameters and computes in bf16 under autocast unless
``--compute_dtype float32``; validation scores the alignment head with the
MrSw kernel on the card; ``--ndcg`` adds NDCG@25 over the minival
relevance matrices on disk. Checkpoints are ``<logger_name>/checkpoint.pth.tar``,
``model_best_rsum.pth.tar`` and, with ``--ndcg``, ``model_best_ndcgspice.pth.tar``;
``--resume`` continues from one.

``run(argv)`` returns {"trainer", "state", "checkpoint"}; ``main`` returns 0.
"""

from __future__ import annotations

import argparse
import gc
import os
from typing import Any, Dict

import numpy as np
import torch

from aladin_torch.cli.common import (
    add_shared_flags,
    build_loaders,
    build_ndcg_scorer,
    build_tokenizer,
    build_train_model,
    compute_dtype_of,
    maybe_create_mesh,
    prepare_synthetic,
    restore_training_settings,
    shard_state_and_loaders,
    to_data_args,
)
from aladin_torch.config import load_config
from aladin_torch.io.checkpoint import load_teacher_params, resume_state
from aladin_torch.parallel.distributed import initialize, rank_logger, shutdown
from aladin_torch.train.loop import Trainer
from aladin_torch.train.state import TrainState
from aladin_torch.utils.device import resolve_device


def _parse(argv):
    parser = argparse.ArgumentParser(description="ALADIN training (PyTorch)")
    add_shared_flags(parser)
    ns = parser.parse_args(argv)
    if ns.int8_encoder:
        # quantization rounds are gradient-dead; the flag is eval/serving only
        parser.error("--int8_encoder is an evaluation/serving flag (cli/test); training runs bf16")
    if ns.steps_per_dispatch < 1:
        parser.error(f"--steps_per_dispatch must be >= 1, got {ns.steps_per_dispatch}")
    if ns.profile_dir and ns.profile_steps < 1:
        parser.error(f"--profile_steps must be >= 1, got {ns.profile_steps}")
    if not ns.config:
        parser.error("--config is required (see aladin_torch/configs/)")
    return ns


def run(argv=None) -> Dict[str, Any]:
    ns = _parse(argv)
    args = to_data_args(ns)
    device = resolve_device(ns.device)
    initialize(device=device.type)
    logger = rank_logger(args.logger_name)
    cfg = load_config(ns.config)
    # batch sizes come from the experiment config
    args.per_gpu_train_batch_size = cfg.training.bs
    args.per_gpu_eval_batch_size = cfg.training.bs
    if args.synthetic:
        args = prepare_synthetic(args)
    args = restore_training_settings(args)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)

    tokenizer = build_tokenizer(args)
    train_loader, val_loader = build_loaders(tokenizer, args, cfg, device)
    logger.info(f"train batches/epoch: {len(train_loader)}  val: {len(val_loader)}  native IO: "
                f"reader {train_loader.dataset.native_enabled}, tokenizer "
                f"{tokenizer.native_enabled}")
    model = build_train_model(cfg, args, device)
    state = TrainState(cfg, model, steps_per_epoch=max(len(train_loader), 1))

    start_epoch, best = 0, -1.0
    if args.resume:
        state, start_epoch, best = resume_state(state, args.resume)
        logger.info(f"resumed from {args.resume} at epoch {start_epoch}, step {state.step} "
                    f"(best rsum {best})")
    elif args.load_teacher_model:
        stats = load_teacher_params(state, args.load_teacher_model)
        logger.info(f"teacher weights from {args.load_teacher_model}: {stats['matched']} loaded, "
                    f"{len(stats['missing'])} missing, {len(stats['unused'])} unused")

    mesh = maybe_create_mesh(args.mesh_shape, device, model)
    if mesh is not None:
        state = shard_state_and_loaders(state, mesh, cfg, args.seed, train_loader)
        logger.info(f"mesh: {mesh.axes}, {cfg.training.bs // mesh.dp} rows a dp rank")

    ndcg_scorer = None
    if args.ndcg:
        ndcg_scorer = build_ndcg_scorer(cfg, args, "minival", len(val_loader.dataset))
        logger.info(f"ndcg scorer: {ndcg_scorer.relevance_methods if ndcg_scorer else None}")
    trainer = Trainer(cfg, args, model, state, train_loader, val_loader, device,
                      compute_dtype=compute_dtype_of(args), ndcg_scorer=ndcg_scorer, mesh=mesh)
    trainer.best_rsum = best
    trainer.fit(start_epoch)
    logger.info(f"done; best rsum {trainer.best_rsum:.2f}")
    return {"trainer": trainer, "state": state,
            "checkpoint": os.path.join(args.logger_name, "checkpoint.pth.tar")}


def main(argv=None) -> int:
    run(argv)  # its result, the Trainer and any CUDA graph with it, is freed here
    gc.collect()
    shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
