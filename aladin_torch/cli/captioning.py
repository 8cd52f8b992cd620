"""Image captioning CLI (mirrors aladin_tpu/cli/captioning.py), the
``oscar/run_captioning.py`` equivalent.

Reference capability (ref:oscar/run_captioning.py:195-1009): masked-caption
LM training over (caption, OD tags, regions) streams with the block
attention layout, greedy / beam inference through the masked-LM decoder,
and COCO caption metrics. The tensorizer emits static shapes; decoding is
full-recompute by default, or the KV-cached prefill + step engine
(tasks/decode_cache.py, ``--kv_cache``) that reproduces the reference's
history_state serving path; ``--use_cbs`` runs the constrained beam search
over detection-derived FSMs; ``--scst_epochs`` fine-tunes on the CIDEr-D
reward after CE training. Metrics run on the host (eval/caption_metrics:
BLEU-1..4, ROUGE-L, CIDEr-D, METEOR where nltk is installed).

    python -m aladin_torch.cli.captioning --data_dir <dir> --eval_model_dir <vocab dir> \\
        [--num_beams 5 | --use_cbs] [--kv_cache] [--scst_epochs 1] [--device cuda]

``--synthetic`` writes a tiny corpus (8 images) and builds a tiny model
(``--device cpu`` runs it without a card):

    python -m aladin_torch.cli.captioning --synthetic --device cpu --epochs 1

Training is f32 with the kernel knobs off, as aladin_tpu's CLI. The
weights are random from ``--seed``, unless ``--eval_model_dir`` holds an
OSCAR captioning checkpoint (``config.json`` + ``pytorch_model.bin``), which
is loaded (``io/convert.py::load_captioner_checkpoint``; aladin_tpu's CLI
reads only the vocab there). Outputs: ``predictions.json`` and
``metrics.json`` in ``--output_dir``, written by rank 0.

Data parallelism: ``torchrun --nproc_per_node N -m aladin_torch.cli.captioning
--mesh_shape dp=N ...``: every rank tensorizes each global batch (the
masking draws stay those of one process) and trains on its rows, with the
global batch's loss; SCST and decoding run the whole batch on every rank,
with a sampling generator that is not folded by rank.

``run(argv)`` returns {"model", "step" (the CE train step), "batch" (its
last inputs, the epoch last), "losses" (each epoch's step losses), "scst_losses",
"predictions", "metrics"}; ``main`` returns 0.
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
from aladin_torch.data.dataset import make_synthetic_dataset
from aladin_torch.data.tokenizer import encode_trunc_any
from aladin_torch.eval.caption_metrics import evaluate_captions
from aladin_torch.io.checkpoint import load_state_dict_report
from aladin_torch.io.convert import load_captioner_checkpoint
from aladin_torch.models.bert_img import BertImgConfig, init_weights
from aladin_torch.parallel import distributed
from aladin_torch.tasks.captioning import (BertImageCaptioner, CaptionTensorizer, StepInputs,
                                           _decode_attention_mask, beam_search_decode,
                                           greedy_decode, make_caption_train_step, sample_decode)
from aladin_torch.tasks.decode_cache import CachedSteps
from aladin_torch.tasks.task_inputs import ImageFeatureProvider
from aladin_torch.utils.device import resolve_device


def gather_masked(logits: torch.Tensor, masked_idx: torch.Tensor) -> torch.Tensor:
    """(B, L, V) logits + (B, M) positions -> (B*M, V) masked-slot logits."""
    out = torch.take_along_dim(logits, masked_idx.long()[:, :, None], dim=1)
    return out.reshape(-1, logits.shape[-1])


def masked_positions(masked_pos: np.ndarray, max_masked: int) -> np.ndarray:
    """Binary (B, L) mask -> (B, M) position indices (0-padded; position 0 is
    CLS, never masked, so 0 doubles as the inactive slot)."""
    b = masked_pos.shape[0]
    out = np.zeros((b, max_masked), np.int32)
    for i in range(b):
        idx = np.where(masked_pos[i] == 1)[0][:max_masked]
        out[i, : len(idx)] = idx
    return out


def decode_inputs(tok, tz: CaptionTensorizer, od_labels, feats_list):
    """Static decode-time inputs for a batch: padded od ids/segments, padded
    features, per-example static block mask."""
    la, lt, li = tz.max_seq_a_len, tz.max_seq_len, tz.max_img_seq_len
    od_width = lt - la
    ids, segs, feats, masks = [], [], [], []
    for od, f in zip(od_labels, feats_list):
        body = encode_trunc_any(tok, od or "", od_width - 1)
        row = body + [tz.sep_id]
        od_len = len(row)
        row = row + [tz.pad_id] * (od_width - od_len)
        ids.append(row)
        segs.append([1] * od_len + [0] * (od_width - od_len))
        img_len = min(f.shape[0], li)
        out = np.zeros((li, tz.img_feature_dim), np.float32)
        out[:img_len] = f[:img_len, : tz.img_feature_dim]
        feats.append(out)
        masks.append(_decode_attention_mask(la, lt, li, od_len, img_len))
    return (np.asarray(ids, np.int32), np.asarray(segs, np.int32),
            np.stack(feats), np.stack(masks))


def detokenize(tok, rows: np.ndarray) -> list:
    """Token-id rows -> caption strings (stop at SEP, drop specials, undo
    wordpiece '##' continuation)."""
    inv = {v: k for k, v in tok.vocab.items()}
    sep = tok.vocab[tok.sep_token]
    special = {tok.vocab[t] for t in
               (tok.cls_token, tok.sep_token, tok.pad_token, tok.mask_token)}
    out = []
    for row in rows:
        words = []
        for t in row.tolist():
            if t == sep:
                break
            if t in special:
                continue
            piece = inv.get(t, tok.unk_token)
            if piece.startswith("##") and words:
                words[-1] += piece[2:]
            else:
                words.append(piece)
        out.append(" ".join(words))
    return out


def cbs_tables(tok, provider: ImageFeatureProvider, keys):
    """(per-example FSM tables (B, S, V) padded to the chunk's largest state
    count with unreachable identity rows, constraints given per example,
    S): the detection-derived constraints of each image
    (ConstraintFilter over its objects)."""
    from aladin_torch.tasks.cbs import ConstraintFilter, FiniteStateMachineBuilder

    filt = ConstraintFilter()
    builder = FiniteStateMachineBuilder(tok.vocab_size)
    tables, n_cons, max_states = [], [], 1
    for k in keys:
        objs = provider.get_objects(k)
        names = filt(
            np.asarray([o.get("rect", [0, 0, 1, 1]) for o in objs], np.float32),
            [o["class"] for o in objs],
            np.asarray([o.get("conf", 1.0) for o in objs], np.float32),
        ) if objs else []
        forms = [[tok.convert_tokens_to_ids(tok.tokenize(n))] for n in names]
        forms = [f for f in forms if f and f[0]]
        nxt, n_states = builder.build(forms)
        tables.append(nxt)
        n_cons.append(len(forms))
        max_states = max(max_states, n_states)
    # extra states are unreachable identity rows; the selection scans main states only
    padded = np.stack([
        np.concatenate([t, np.tile(np.arange(t.shape[0], max_states, dtype=np.int32)[:, None],
                                   (1, tok.vocab_size))]) if t.shape[0] < max_states else t
        for t in tables])
    return padded, np.asarray(n_cons), max_states


def _parse(argv):
    p = argparse.ArgumentParser(description="image captioning (PyTorch)")
    p.add_argument("--data_dir", default="datasets/coco_caption")
    p.add_argument("--img_feat_file", default="")
    p.add_argument("--eval_model_dir", default="", help="vocab (and captioner checkpoint) source")
    p.add_argument("--output_dir", default="output/captioning")
    p.add_argument("--max_seq_length", type=int, default=70)
    p.add_argument("--max_seq_a_length", type=int, default=40)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--img_feature_dim", type=int, default=2054)
    add_hidden_act_flag(p)
    p.add_argument("--mask_prob", type=float, default=0.15)
    p.add_argument("--max_masked_tokens", type=int, default=3)
    p.add_argument("--label_smoothing", type=float, default=0.1)
    p.add_argument("--drop_worst_ratio", type=float, default=0.0)
    p.add_argument("--drop_worst_after", type=int, default=0)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--eval_batch_size", type=int, default=64,
                   help="decode batch at eval; inputs are built and decoded per batch so the "
                        "image set never materializes whole")
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--num_beams", type=int, default=1, help="1 = greedy, >1 = beam search")
    p.add_argument("--scst_epochs", type=int, default=0,
                   help="self-critical (CIDEr-reward) fine-tune epochs after CE training "
                        "(ref:run_captioning.py:522-580)")
    p.add_argument("--scst_lr", type=float, default=1e-5)
    p.add_argument("--scst_top_k", type=int, default=5)
    p.add_argument("--kv_cache", action="store_true",
                   help="decode with the prefill+step KV-cache engine (tasks/decode_cache.py) "
                        "instead of full recompute; the same outputs, lower per-step cost")
    p.add_argument("--use_cbs", action="store_true",
                   help="constrained beam search over detection-derived FSMs "
                        "(ref:run_captioning.py --use_cbs / oscar/utils/cbs.py)")
    p.add_argument("--min_constraints_to_satisfy", type=int, default=2)
    p.add_argument("--log_step", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mesh_shape", default="dp=-1",
                   help="dp=N under torchrun (one process a GPU) for data-parallel CE "
                        "training; dp=-1 = every rank")
    p.add_argument("--synthetic", action="store_true")
    add_device_flag(p)
    return p.parse_args(argv)


def _model_config(ns, tok) -> BertImgConfig:
    if ns.synthetic:
        return BertImgConfig(hidden_act=ns.hidden_act, vocab_size=tok.vocab_size, hidden_size=64,
                             num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                             max_position_embeddings=256, img_feature_dim=ns.img_feature_dim)
    return BertImgConfig(hidden_act=ns.hidden_act, vocab_size=tok.vocab_size,
                         img_feature_dim=ns.img_feature_dim)


def _build_model(ns, tok, device, logger) -> BertImageCaptioner:
    """The captioner on ``device``: random from ``--seed``, then an OSCAR
    captioning checkpoint's weights where ``--eval_model_dir`` holds one."""
    cfg = _model_config(ns, tok)
    model = BertImageCaptioner(cfg)
    init_weights(model, torch.Generator().manual_seed(ns.seed), cfg.initializer_range)
    if ns.eval_model_dir and os.path.exists(os.path.join(ns.eval_model_dir,
                                                         "pytorch_model.bin")):
        sd, _ = load_captioner_checkpoint(ns.eval_model_dir)
        stats = load_state_dict_report(model, sd)
        if stats["missing"]:
            raise ValueError(f"{ns.eval_model_dir}: captioner tensors missing from "
                             f"pytorch_model.bin: {stats['missing'][:8]}")
        logger.info(f"loaded the captioner from {ns.eval_model_dir}")
    model.bert.seed_generator.manual_seed(ns.seed)
    torch.manual_seed(ns.seed)
    return model.to(device)


def run(argv=None) -> Dict[str, Any]:  # noqa: C901 - one CLI: train, SCST, decode
    ns = _parse(argv)
    device = resolve_device(ns.device)
    distributed.initialize(device=device.type)
    logger = distributed.rank_logger(ns.output_dir)

    if ns.synthetic:
        ns.data_dir = os.path.join(ns.output_dir, "synthetic_caption")
        if distributed.is_main_process():
            make_synthetic_dataset(ns.data_dir, n_images=8, feat_dim=ns.img_feature_dim)
        distributed.barrier("synthetic")
    if not ns.img_feat_file:
        ns.img_feat_file = os.path.join(ns.data_dir, "features.tsv")
    tok = task_tokenizer(ns.eval_model_dir)
    provider = ImageFeatureProvider(ns.img_feat_file)
    with open(os.path.join(ns.data_dir, "train_captions.json")) as f:
        captions = {str(k): v for k, v in json.load(f).items()}
    keys = sorted(captions.keys())
    items = [(k, c) for k in keys for c in captions[k]]
    logger.info(f"{len(items)} (image, caption) pairs / {len(keys)} images")

    tz = CaptionTensorizer(
        tok, max_img_seq_length=ns.max_img_seq_length, max_seq_length=ns.max_seq_length,
        max_seq_a_length=ns.max_seq_a_length, mask_prob=ns.mask_prob,
        max_masked_tokens=ns.max_masked_tokens, img_feature_dim=ns.img_feature_dim,
        is_train=True, seed=ns.seed)
    model = _build_model(ns, tok, device, logger)

    def collate(batch_items):
        rows = [tz.tensorize(c, provider.get_od_labels(k), provider.get_image(k))
                for k, c in batch_items]
        ids, attn, seg, feats, mpos, mids = (np.stack(x) for x in zip(*rows))
        midx = masked_positions(mpos, ns.max_masked_tokens)
        return ids, attn, seg, feats, midx, mids.astype(np.int32)

    rng = np.random.RandomState(ns.seed)
    bs = min(ns.train_batch_size, len(items))
    # aladin_tpu initializes its parameters from one collated batch: the same
    # draws keep the masking of every later batch the same in both packages
    collate(items[:bs])
    mesh, rows = data_parallel(model, ns.mesh_shape, bs, ns.seed, device)
    steps_per_epoch = max(len(items) // bs, 1)
    optimizer, _ = make_optimizer(model, ns.learning_rate, ns.warmup_steps,
                                  ns.epochs * steps_per_epoch)
    step = make_caption_train_step(model, optimizer, ns.label_smoothing, ns.drop_worst_ratio,
                                   ns.drop_worst_after, mesh=mesh)

    def to_device(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]

    losses, batch = [], None
    for epoch in range(ns.epochs):
        t0, window = time.time(), []
        order = rng.permutation(len(items))
        for i in range(steps_per_epoch):
            glob = collate([items[j] for j in order[i * bs: (i + 1) * bs]])
            batch = [*to_device(a[rows] for a in glob), epoch]
            window.append(step(*batch)["loss"])
        vals = [v.item() for v in window]
        losses.append(vals)
        logger.info(f"epoch {epoch} loss {np.mean(vals):.4f} ({time.time() - t0:.1f}s)")

    def build_inputs(sel_keys):
        """Decode-time inputs of a batch of image keys, on the device (built
        per batch: the whole image set never materializes)."""
        return to_device(decode_inputs(tok, tz, [provider.get_od_labels(k) for k in sel_keys],
                                       [provider.get_image(k) for k in sel_keys]))

    common = dict(max_steps=ns.max_seq_a_length - 1, cls_id=tok.vocab[tok.cls_token],
                  sep_id=tok.vocab[tok.sep_token], mask_id=tok.vocab[tok.mask_token],
                  pad_id=tz.pad_id)
    # the step source of every decoding policy below (CBS runs its own, full-recompute loop)
    steps = StepInputs
    if ns.kv_cache:
        steps = CachedSteps
        if ns.use_cbs:
            logger.warning("--kv_cache has no effect with --use_cbs: the constrained beam "
                           "search decoder is full-recompute")

    scst_losses = []
    if ns.scst_epochs > 0:
        from aladin_torch.tasks.scst import ScstRewardCriterion, make_scst_step

        scst = ScstRewardCriterion()
        sb = min(ns.train_batch_size, len(keys))
        # horizon in optimizer steps (batches), not examples
        opt2, _ = make_optimizer(model, ns.scst_lr, 0, ns.scst_epochs * max(len(keys) // sb, 1))
        scst_step = make_scst_step(model, opt2, mask_id=common["mask_id"],
                                   pad_id=common["pad_id"], mesh=mesh)
        # not folded by rank: every rank samples the same captions
        gen = torch.Generator(device=device).manual_seed(ns.seed)
        for epoch in range(ns.scst_epochs):
            t0, window, rews = time.time(), [], []
            order = rng.permutation(len(keys))
            for s in range(0, len(keys) - sb + 1, sb):
                sel = order[s: s + sb]
                inp = build_inputs([keys[j] for j in sel])
                sampled = sample_decode(steps, model, *inp, gen, top_k=ns.scst_top_k, **common)
                greedy, _ = greedy_decode(steps, model, *inp, **common)
                adv = scst.rewards(detokenize(tok, sampled.cpu().numpy()),
                                   detokenize(tok, greedy.cpu().numpy()),
                                   [captions[keys[j]] for j in sel]).astype(np.float32)
                window.append(scst_step(sampled, torch.from_numpy(adv).to(device), *inp)["loss"])
                rews.append(float(adv.mean()))
            vals = [v.item() for v in window]
            scst_losses.append(vals)
            logger.info(f"scst epoch {epoch} loss {np.mean(vals):.4f} "
                        f"mean-advantage {np.mean(rews):.4f} ({time.time() - t0:.1f}s)")

    def decode_chunk(ck):
        """Decode one fixed-size batch of image keys -> (len(ck), L) ids."""
        inp = build_inputs(ck)
        if ns.use_cbs:
            from aladin_torch.tasks.cbs import cbs_decode, select_best_beam_with_constraints

            tables, n_cons, n_states = cbs_tables(tok, provider, ck)
            beams, scores, _ = cbs_decode(model, *inp, torch.from_numpy(tables).to(device),
                                          num_beams=max(ns.num_beams, 2), num_states=n_states,
                                          **common)
            toks, _ = select_best_beam_with_constraints(
                beams.cpu().numpy(), scores.cpu().numpy(), n_cons,
                ns.min_constraints_to_satisfy)
            return toks
        if ns.num_beams > 1:
            toks, _ = beam_search_decode(steps, model, *inp, num_beams=ns.num_beams, **common)
        else:
            toks, _ = greedy_decode(steps, model, *inp, **common)
        return toks.cpu().numpy()

    # decode every image once in fixed-size batches (the tail padded to the
    # batch size), score against the reference captions
    eb = min(ns.eval_batch_size, len(keys))
    parts = []
    for s in range(0, len(keys), eb):
        ck = list(keys[s: s + eb])
        pad = eb - len(ck)
        if pad:
            ck = ck + [ck[-1]] * pad
        parts.append(decode_chunk(ck)[: eb - pad])
    hyps = detokenize(tok, np.concatenate(parts))
    preds = {k: [h] for k, h in zip(keys, hyps)}
    metrics = evaluate_captions(preds, {k: captions[k] for k in keys})
    logger.info("caption metrics: " + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()
                                               if isinstance(v, float)))
    if distributed.is_main_process():  # one writer on a shared output_dir
        os.makedirs(ns.output_dir, exist_ok=True)
        with open(os.path.join(ns.output_dir, "predictions.json"), "w") as f:
            json.dump([{"image_id": k, "caption": h} for k, h in zip(keys, hyps)], f)
        with open(os.path.join(ns.output_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2, default=str)
    distributed.barrier("captioning_outputs")
    return {"model": model, "step": step, "batch": batch, "losses": losses,
            "scst_losses": scst_losses, "predictions": preds, "metrics": metrics}


def main(argv=None) -> int:
    run(argv)
    gc.collect()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
