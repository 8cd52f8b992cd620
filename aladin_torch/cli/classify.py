"""VQA / GQA / NLVR2 task driver (mirrors aladin_tpu/cli/classify.py), the
run_vqa.py / run_gqa.py / run_nlvr.py equivalent, one driver parameterized
by ``--task``:

  * vqa:  soft-answer classification over the answer vocabulary; loss bce
    (instance BCE x n_labels), kl or ce; eval metric = the soft-target
    score of the argmax answer (ref:run_vqa.py:428-434
    compute_score_with_logits); ``--do_test`` writes {question_id, answer}
    json (ref:run_vqa.py:787-839).
  * gqa:  single-answer CE; accuracy = exact match (ref:run_gqa.py).
  * nlvr: pair choice over (statement, left / right image) streams through
    ImageBertForMultipleChoice, 2 x B streams a batch; accuracy
    (ref:run_nlvr.py).

Training draws the same shuffled batches as aladin_tpu (``_batches`` over
a RandomState of ``--seed``); evaluation covers every example, its last
batch padded to the batch size and cut to the true count.

    python -m aladin_torch.cli.classify --task vqa --data_dir <dir> \\
        --eval_model_dir <vocab dir> [--do_test] [--device cuda]

``--synthetic`` builds an on-disk fixture whose questions are answerable
from the OD tags, and a tiny model (``--device cpu`` runs it without a
card). Data parallelism: ``torchrun --nproc_per_node N -m
aladin_torch.cli.classify --mesh_shape dp=N ...``: every rank draws the
same batches and trains on its rows of each, with the global batch's loss;
each rank evaluates every example, and rank 0 logs and writes.

``run(argv)`` returns {"model", "step" (the train step), "batch" (its last
inputs), "losses", "val_scores", "test_results"}; ``main`` returns 0.
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

from aladin_torch.cli.common import add_device_flag, add_hidden_act_flag, task_tokenizer
from aladin_torch.cli.pretrain import data_parallel, make_optimizer
from aladin_torch.data.dataset import DisentangledTensorizer
from aladin_torch.models.bert_img import BertImgConfig, ImageBertClassifier, init_weights
from aladin_torch.parallel import distributed
from aladin_torch.tasks.classification import (ImageBertForMultipleChoice,
                                               make_classifier_train_step, make_predict_step)
from aladin_torch.tasks.task_inputs import (ImageFeatureProvider, convert_gqa_batch,
                                            convert_nlvr_batch, convert_vqa_batch,
                                            load_answer_vocab, load_gqa_examples,
                                            load_nlvr_examples, load_vqa_examples,
                                            make_synthetic_task_data)
from aladin_torch.utils.device import resolve_device


def _batches(n, bs, rng=None, drop_last=True):
    """Index batches; empty splits / bs<=0 yield nothing. With
    drop_last=False the final batch may be short — eval/test must cover
    every example (ref:run_vqa.py:787-839 predicts all of them)."""
    if n <= 0 or bs <= 0:
        return
    order = np.arange(n) if rng is None else rng.permutation(n)
    end = n - bs + 1 if drop_last else n
    for s in range(0, end, bs):
        yield order[s: s + bs]


def _parse(argv):
    p = argparse.ArgumentParser(description="VQA/GQA/NLVR2 (PyTorch)")
    p.add_argument("--task", choices=("vqa", "gqa", "nlvr"), default="vqa")
    p.add_argument("--data_dir", default="datasets/vqa")
    p.add_argument("--img_feat_file", default="")
    p.add_argument("--eval_model_dir", default="", help="vocab + backbone ckpt dir")
    p.add_argument("--output_dir", default="output/classify")
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--img_feature_dim", type=int, default=2054)
    add_hidden_act_flag(p)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--loss_type", choices=("bce", "kl", "ce"), default="bce",
                   help="vqa only; gqa/nlvr use ce (ref:run_vqa.py loss_type)")
    p.add_argument("--log_step", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mesh_shape", default="dp=-1",
                   help="dp=N under torchrun (one process a GPU); dp=-1 = every rank")
    p.add_argument("--do_test", action="store_true",
                   help="dump test predictions json (ref:run_vqa.py:787-839)")
    p.add_argument("--synthetic", action="store_true")
    add_device_flag(p)
    return p.parse_args(argv)


def run(argv=None) -> Dict[str, Any]:  # noqa: C901 - one driver, three tasks
    ns = _parse(argv)
    device = resolve_device(ns.device)
    distributed.initialize(device=device.type)
    logger = distributed.rank_logger(ns.output_dir)

    if ns.synthetic:
        ns.data_dir = os.path.join(ns.output_dir, "synthetic_task")
        if distributed.is_main_process():
            make_synthetic_task_data(ns.data_dir, feat_dim=ns.img_feature_dim)
        distributed.barrier("synthetic")
    if not ns.img_feat_file:
        ns.img_feat_file = os.path.join(ns.data_dir, "features.tsv")
    tokenizer = task_tokenizer(ns.eval_model_dir)
    provider = ImageFeatureProvider(ns.img_feat_file)
    tz = DisentangledTensorizer(tokenizer, ns.max_seq_length, ns.max_img_seq_length,
                                ns.img_feature_dim)

    ans2label = {}
    if ns.task in ("vqa", "gqa"):
        ans2label = load_answer_vocab(os.path.join(ns.data_dir, "answers.txt"))
    label2ans = {v: k for k, v in ans2label.items()}
    num_labels = max(len(ans2label), 1) if ns.task != "nlvr" else 2

    def load_split(split):
        path = os.path.join(ns.data_dir, f"{ns.task}_{split}.jsonl")
        if ns.task == "vqa":
            return load_vqa_examples(path, ans2label)
        if ns.task == "gqa":
            return load_gqa_examples(path, ans2label)
        return load_nlvr_examples(path)

    def convert(examples):
        """The numpy batch of ``examples`` as tensors on the device."""
        if ns.task == "vqa":
            out = convert_vqa_batch(examples, tz, provider.get_image, provider.get_od_labels,
                                    num_labels)
        elif ns.task == "gqa":
            out = convert_gqa_batch(examples, tz, provider.get_image, provider.get_od_labels)
        else:
            out = convert_nlvr_batch(examples, tz, provider.get_image, provider.get_od_labels)
        return [torch.from_numpy(a).to(device) for a in out]

    train, val = load_split("train"), load_split("val")
    logger.info(f"{ns.task}: {len(train)} train / {len(val)} val, {num_labels} labels")

    if ns.synthetic:
        cfg = BertImgConfig(hidden_act=ns.hidden_act, vocab_size=tokenizer.vocab_size,
                            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=128, max_position_embeddings=256,
                            img_feature_dim=ns.img_feature_dim, num_labels=num_labels)
    else:
        cfg = BertImgConfig(hidden_act=ns.hidden_act, vocab_size=tokenizer.vocab_size,
                            img_feature_dim=ns.img_feature_dim, num_labels=num_labels)
    model = (ImageBertForMultipleChoice(cfg, num_choices=2, num_labels=2) if ns.task == "nlvr"
             else ImageBertClassifier(cfg))
    init_weights(model, torch.Generator().manual_seed(ns.seed), cfg.initializer_range)
    model.bert.seed_generator.manual_seed(ns.seed)
    torch.manual_seed(ns.seed)
    model.to(device)

    loss_type = ns.loss_type if ns.task == "vqa" else "ce"
    rng = np.random.RandomState(ns.seed)
    bs = min(ns.train_batch_size, len(train))
    mesh, rows = data_parallel(model, ns.mesh_shape, bs, ns.seed, device)
    steps_per_epoch = max(len(train) // ns.train_batch_size, 1)
    optimizer, _ = make_optimizer(model, ns.learning_rate, ns.warmup_steps,
                                  ns.epochs * steps_per_epoch)
    train_step = make_classifier_train_step(model, optimizer, loss_type, mesh=mesh)
    predict = make_predict_step(model)

    eval_layouts = {}

    def eval_batches(examples, split):
        """(true count, indices, batch) covering EVERY example, the tail
        padded to the batch size; the index layout is kept across epochs and
        the batches are tensorized again each time, so evaluation memory is
        one batch (ref protocol: run_vqa.py:682-764)."""
        if split not in eval_layouts:
            ebs = min(ns.train_batch_size, max(len(examples), 1))
            layout = []
            for idx in _batches(len(examples), ebs, drop_last=False):
                k = len(idx)
                if k < ebs:
                    idx = np.concatenate([idx, np.zeros(ebs - k, idx.dtype)])
                layout.append((k, idx))
            eval_layouts[split] = layout
        for k, idx in eval_layouts[split]:
            yield k, idx, convert([examples[i] for i in idx])

    def evaluate(examples, split="val"):
        """Task accuracy over a split (ref:run_vqa.py:682-764 evaluate)."""
        total, n = 0.0, 0
        for k, _, batch in eval_batches(examples, split):
            pred = predict(*batch[:4])[0][:k]
            if ns.task == "vqa":  # soft-target score of the argmax answer
                total += float(torch.take_along_dim(batch[4][:k], pred[:, None], 1).sum())
            else:
                total += float((pred == batch[4][:k]).sum())
            n += k
        return total / max(n, 1)

    losses, val_scores, batch = [], [], None
    for epoch in range(ns.epochs):
        t0, window = time.time(), []
        for i, idx in enumerate(_batches(len(train), bs, rng)):
            batch = convert([train[j] for j in idx[rows]])[:5]
            window.append(train_step(*batch)["loss"])
            if (i + 1) % ns.log_step == 0:
                vals = [v.item() for v in window]
                logger.info(f"epoch {epoch} step {i + 1} loss {np.mean(vals):.4f}")
                losses += vals
                window = []
        losses += [v.item() for v in window]
        acc = evaluate(val)
        val_scores.append(acc)
        logger.info(f"epoch {epoch} val {'score' if ns.task == 'vqa' else 'acc'} "
                    f"{acc:.4f} ({time.time() - t0:.1f}s)")

    out = None
    if ns.do_test:
        test = load_split("test")
        results = []
        for k, idx, batch in eval_batches(test, "test"):
            pred = predict(*batch[:4])[0][:k].tolist()
            for j, ex in zip(pred, [test[i] for i in idx[:k]]):
                qid = getattr(ex, "qid", getattr(ex, "uid", ""))
                ans = label2ans.get(int(j), int(j)) if ns.task != "nlvr" else int(j)
                results.append({"question_id": qid, "answer": ans})
        out = os.path.join(ns.output_dir, f"{ns.task}_test_results.json")
        if distributed.is_main_process():
            os.makedirs(ns.output_dir, exist_ok=True)
            with open(out, "w") as f:
                json.dump(results, f)
            logger.info(f"wrote {len(results)} predictions to {out}")
        distributed.barrier("classify_test")
    return {"model": model, "step": train_step, "batch": batch, "losses": losses,
            "val_scores": val_scores, "test_results": out}


def main(argv=None) -> int:
    run(argv)
    gc.collect()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
