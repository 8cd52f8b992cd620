"""OSCAR+ pretraining CLI (mirrors aladin_tpu/cli/pretrain.py), the
``oscar/run_oscarplus_pretrain.py`` equivalent.

Reference capability (ref:oscar/run_oscarplus_pretrain.py:41-549): multi-
corpus MLM + contrastive sequence-relation pretraining with AdamW (no decay
on biases and LayerNorms), WarmupLinearSchedule over max_iters, an optional
grad-norm clip, a checkpoint every ckpt_period, and metrics averaged over
the ranks. Each iteration draws B corpus indices with
``rng.randint(len(corpus), size=B)`` and collates them for epoch = the
iteration, as aladin_tpu does, so both packages see the same batches.

    python -m aladin_torch.cli.pretrain --pretrain_root <dir> --datasets coco,flickr30k \\
        --eval_model_dir <vocab dir> [--device cuda]

``--synthetic`` builds a 2-dataset corpus fixture on disk and a tiny model
(``--device cpu`` runs it without a card):

    python -m aladin_torch.cli.pretrain --synthetic --max_iters 20 --device cpu

Checkpoints: ``<output_dir>/ckpt_<iteration:07d>.pth.tar`` holding
{"model": state dict, "iteration": n}, written by rank 0 every
``--ckpt_period`` iterations and after the last (aladin_tpu writes orbax
directories, which the port does not read or write). TensorBoard scalars go
to ``<output_dir>/tb`` when tensorboard is installed.

Data parallelism: one process a GPU under ``torchrun`` with
``--mesh_shape dp=N``; rank 0's initial weights go to every rank, every
rank draws the same global indices and collates its own rows
``[r * B / dp, (r + 1) * B / dp)``, and the loss is the global batch's
(tasks/pretraining.py). B must divide by dp (aladin_tpu warns and runs
unsharded instead):

    torchrun --nproc_per_node N -m aladin_torch.cli.pretrain --mesh_shape dp=N ...

``run(argv)`` returns {"model", "optimizer", "step" (the train step),
"batch" (its last inputs), "log" (one entry a log window, with each step's
metrics), "checkpoints"}; ``main`` returns 0.
"""

from __future__ import annotations

import argparse
import gc
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from aladin_torch.cli.common import (add_device_flag, add_hidden_act_flag, maybe_create_mesh,
                                     task_tokenizer)
from aladin_torch.io.checkpoint import save_task_checkpoint
from aladin_torch.models.bert_img import BertImgConfig, init_weights
from aladin_torch.parallel import distributed
from aladin_torch.parallel.mesh import broadcast_
from aladin_torch.tasks.pretrain_data import PretrainCorpus, make_synthetic_pretrain_corpus
from aladin_torch.tasks.pretraining import BertImgForPreTraining, make_pretrain_step
from aladin_torch.train.schedule import AdamW, warmup_linear_schedule
from aladin_torch.utils.device import resolve_device


def make_optimizer(model: torch.nn.Module, lr: float, warmup_steps: int, t_total: int,
                   weight_decay: float = 0.01, adam_epsilon: float = 1e-8,
                   max_grad_norm: float = -1.0):
    """(AdamW, schedule) with the reference's no-decay split: biases and
    LayerNorm parameters get weight_decay 0 (ref:run_oscarplus_pretrain.py:
    290-299; aladin_tpu's cli/pretrain.py mask, which has no LayerNorm-scale
    clause: ``decay_mask(exclude_scales=False)``), WarmupLinearSchedule over
    t_total, and the global-norm clip before AdamW when max_grad_norm > 0."""
    sched = warmup_linear_schedule(lr, warmup_steps, t_total)
    opt = AdamW(model, sched, weight_decay, adam_epsilon, max_grad_norm, exclude_scales=False)
    return opt, sched


def data_parallel(model: torch.nn.Module, mesh_shape: str, batch_size: int, seed: int, device):
    """(mesh or None, this rank's rows of a global batch): with more than
    one rank, rank 0's parameters on every rank and the rank folded into the
    dropout generators. B must divide by dp."""
    mesh = maybe_create_mesh(mesh_shape, device)
    if mesh is None:
        return None, slice(0, batch_size)
    if mesh.tp > 1:
        raise ValueError(f"{mesh_shape}: the OSCAR task CLIs shard the batch over dp only; "
                         "tensor parallelism (tp > 1) is cli/train's")
    dp = mesh.dp
    if batch_size % dp:
        raise ValueError(f"batch size {batch_size} must be divisible by dp={dp}")
    broadcast_(mesh, list(model.state_dict().values()))
    folded = distributed.rank_seed(seed, mesh.rank)
    torch.manual_seed(folded)
    model.bert.seed_generator.manual_seed(folded)
    rows = batch_size // dp
    return mesh, slice(mesh.rank * rows, (mesh.rank + 1) * rows)


def _parse(argv):
    p = argparse.ArgumentParser(description="OSCAR+ pretraining (PyTorch)")
    p.add_argument("--pretrain_root", default="datasets/pretrain")
    p.add_argument("--datasets", default="coco,flickr30k",
                   help="comma-joined corpus subsets (ref corpus naming)")
    p.add_argument("--eval_model_dir", default="", help="vocab source (checkpoint dir)")
    p.add_argument("--output_dir", default="output/pretrain")
    p.add_argument("--max_seq_length", type=int, default=35)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--img_feature_dim", type=int, default=2054)
    add_hidden_act_flag(p)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=-1.0)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--max_iters", type=int, default=100)
    p.add_argument("--ckpt_period", type=int, default=10000)
    p.add_argument("--log_step", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--use_b", type=int, default=1)
    p.add_argument("--texta_false_prob", type=float, default=0.0)
    p.add_argument("--num_contrast_classes", type=int, default=2)
    p.add_argument("--mask_loss_for_unmatched", type=int, default=1)
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
    datasets = ns.datasets.split(",")

    if ns.synthetic:
        ns.pretrain_root = os.path.join(ns.output_dir, "synthetic_pretrain")
        if distributed.is_main_process():
            make_synthetic_pretrain_corpus(ns.pretrain_root, datasets,
                                           feat_dim=ns.img_feature_dim)
        distributed.barrier("synthetic")
    tokenizer = task_tokenizer(ns.eval_model_dir)
    corpus = PretrainCorpus(
        ns.pretrain_root, tokenizer, datasets,
        seq_len=ns.max_seq_length, max_img_seq_length=ns.max_img_seq_length,
        img_feature_dim=ns.img_feature_dim, use_b=bool(ns.use_b),
        texta_false_prob=ns.texta_false_prob,
        num_contrast_classes=ns.num_contrast_classes,
        mask_loss_for_unmatched=bool(ns.mask_loss_for_unmatched), seed=ns.seed,
    )
    logger.info(f"corpus: {len(corpus)} examples from {ns.datasets}")

    if ns.synthetic:
        cfg = BertImgConfig(hidden_act=ns.hidden_act, vocab_size=tokenizer.vocab_size,
                            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=128, max_position_embeddings=128,
                            img_feature_dim=ns.img_feature_dim)
    else:
        cfg = BertImgConfig(hidden_act=ns.hidden_act, vocab_size=tokenizer.vocab_size,
                            img_feature_dim=ns.img_feature_dim)
    model = BertImgForPreTraining(cfg, num_contrast_classes=ns.num_contrast_classes)
    init_weights(model, torch.Generator().manual_seed(ns.seed), cfg.initializer_range)
    model.bert.seed_generator.manual_seed(ns.seed)
    torch.manual_seed(ns.seed)
    model.to(device)

    rng = np.random.RandomState(ns.seed)
    # aladin_tpu initializes its parameters from one drawn batch: the same
    # draw keeps the iterations' index draws the same in both packages
    rng.randint(len(corpus), size=ns.train_batch_size)
    mesh, rows = data_parallel(model, ns.mesh_shape, ns.train_batch_size, ns.seed, device)
    if mesh is not None:
        logger.info(f"mesh: {mesh.axes}, {rows.stop - rows.start} rows a rank")
    optimizer, sched = make_optimizer(model, ns.learning_rate, ns.warmup_steps, ns.max_iters,
                                      adam_epsilon=ns.adam_epsilon,
                                      max_grad_norm=ns.max_grad_norm)
    step_fn = make_pretrain_step(model, optimizer, mesh=mesh)

    # main-process-only TB writer with smoothed windows, the reference's
    # pretrain observability (ref:oscar/run_oscarplus_pretrain.py +
    # oscar/utils/metric_logger.py:115-185)
    tb = None
    if distributed.is_main_process():
        from aladin_torch.utils.metric_logger import TensorboardLogger

        tb = TensorboardLogger(os.path.join(ns.output_dir, "tb"))
    log, checkpoints, pending, batch = [], [], [], None
    t0 = time.time()
    for it in range(ns.max_iters):
        idx = rng.randint(len(corpus), size=ns.train_batch_size)
        b = corpus.collate(idx[rows], epoch=it)
        batch = [torch.from_numpy(b[k]).to(device) for k in
                 ("input_ids", "attention_mask", "token_type_ids", "img_feats", "lm_labels",
                  "is_next")]
        pending.append(step_fn(*batch))
        if (it + 1) % ns.log_step == 0 or it + 1 == ns.max_iters:
            fetched = [{k: v.item() for k, v in m.items()} for m in pending]  # one sync a window
            dt = (time.time() - t0) / len(pending)
            agg = distributed.all_reduce_metrics(
                {k: float(np.mean([m[k] for m in fetched])) for k in fetched[0]})
            logger.info(f"iter {it + 1}/{ns.max_iters} "
                        + " ".join(f"{k} {v:.4f}" for k, v in sorted(agg.items()))
                        + f" lr {sched(it):.2e} {dt * 1000:.0f} ms/it")
            log.append({"iter": it + 1, **agg, "lr": sched(it), "ms_per_it": dt * 1000,
                        "steps": fetched})
            if tb is not None:
                tb.iteration = it + 1
                tb.update(lr=sched(it), batch_time=dt, **agg)
            pending, t0 = [], time.time()
        if (it + 1) % ns.ckpt_period == 0 or it + 1 == ns.max_iters:
            path = os.path.abspath(os.path.join(ns.output_dir, f"ckpt_{it + 1:07d}.pth.tar"))
            if distributed.is_main_process():  # one writer on a shared output_dir
                save_task_checkpoint(path, model, it + 1)
                logger.info(f"saved {path}")
            checkpoints.append(path)
            distributed.barrier("pretrain_ckpt")
    if tb is not None:
        tb.writer.close()
    return {"model": model, "optimizer": optimizer, "step": step_fn, "batch": batch,
            "log": log, "checkpoints": checkpoints}


def main(argv=None) -> int:
    run(argv)
    gc.collect()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
