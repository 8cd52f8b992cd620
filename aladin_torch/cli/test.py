"""Evaluation CLI, the serving path (mirrors aladin_tpu/cli/test.py).

Loads a released ``.pth.tar`` (``--load_checkpoint``; its embedded recipe
is the config) or builds the model from ``--config`` (+ an OSCAR directory
in ``--eval_model_dir``), encodes the test split with both heads, and
reports matching-head R@K and alignment-head R@K from the all-pairs MrSw
scores (the CUDA kernel on the card; ``--compute_dtype int8`` scores with
int8 operands). ``--int8_encoder`` runs the encoder's QKV and FFN-up
projections as W8A8 int8 GEMMs (kernel K4-dynx on the card). ``--ndcg``
adds the alignment head's NDCG@25 from the relevance matrices on disk
(``cli/common.py::build_ndcg_scorer``), per fold under ``--fivefold``.
Under ``torchrun`` with ``--mesh_shape dp=N`` every rank encodes the
whole split (replicated, as in aladin_tpu) and the alignment head's
caption axis is scored sharded over the ranks
(``parallel/mesh.py::sharded_mrsw_scores``); rank 0 alone logs.

    python -m aladin_torch.cli.test --config aladin_torch/configs/<recipe>.json \\
        --eval_model_dir <oscar dir> --data_dir <coco_ir> --img_feat_file <features.tsv> \\
        --eval_img_keys_file test_img_keys_1k.tsv --add_od_labels [--device cuda]

``run(argv)`` returns the metric dicts; ``main(argv)`` returns 0.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from aladin_torch.cli.common import (
    add_shared_flags,
    build_model,
    build_ndcg_scorer,
    build_tokenizer,
    maybe_create_mesh,
    prepare_synthetic,
    restore_training_settings,
    to_data_args,
)
from aladin_torch.config import ExperimentConfig, load_config
from aladin_torch.data.dataset import RetrievalDataset
from aladin_torch.data.pipeline import BatchLoader
from aladin_torch.eval.encode import encode_data
from aladin_torch.eval.recall import compute_recall, recall_1k_5fold
from aladin_torch.eval.retrieval import (evaluate_alignment_head, fivefold_from_scores,
                                         ndcg_from_scores)
from aladin_torch.io.checkpoint import load_checkpoint, load_state_dict_report
from aladin_torch.parallel.distributed import initialize, rank_logger, shutdown
from aladin_torch.parallel.mesh import sharded_mrsw_scores
from aladin_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parse(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="ALADIN evaluation (PyTorch)")
    add_shared_flags(parser)
    parser.add_argument("--load_checkpoint", default="", help="reference .pth.tar checkpoint")
    parser.add_argument("--test_split", default="test")
    parser.add_argument("--fivefold", action="store_true",
                        help="5 x 1k-fold protocol over the 5k set")
    parser.add_argument("--bucketed_encode", action="store_true",
                        help="length-sorted, length-trimmed encode batches")
    return parser.parse_args(argv)


def run(argv=None) -> Dict[str, Any]:
    """Evaluate; returns {"matching", "alignment_i2t", "alignment_t2i",
    "scores", "encode_seconds", "score_seconds", "ndcg_seconds",
    "native_io"}; ``score_seconds`` includes ``ndcg_seconds``, the NDCG
    pass on the host (under ``--fivefold`` the folds' whole metric pass; 0
    without ``--ndcg``)."""
    ns = _parse(argv)
    args = to_data_args(ns)
    device = resolve_device(ns.device)
    initialize(device=device.type)
    mesh = maybe_create_mesh(args.mesh_shape, device)
    logger = rank_logger(args.logger_name)

    cfg_dict, payload = None, None
    if ns.load_checkpoint:
        payload, cfg_dict = load_checkpoint(ns.load_checkpoint)
    if cfg_dict:
        cfg = ExperimentConfig.from_dict(cfg_dict)
    elif ns.config:
        cfg = load_config(ns.config)
    else:
        raise ValueError("need --config when the checkpoint has no embedded config")
    # evaluate BOTH heads regardless of the training loss
    d = cfg.to_dict()
    d["training"]["loss-type"] = "alignment-distillation"
    cfg = ExperimentConfig.from_dict(d)

    if args.synthetic:
        args = prepare_synthetic(args)
    args = restore_training_settings(args)

    tokenizer = build_tokenizer(args)
    test_ds = RetrievalDataset(tokenizer, args, ns.test_split, is_train=False)
    loader = BatchLoader(test_ds, cfg.training.bs, shuffle=False, drop_last=False,
                         device=device, sort_by_length=ns.bucketed_encode,
                         trim_multiple=16 if ns.bucketed_encode else 0)
    native_io = {"reader": test_ds.native_enabled, "tokenizer": tokenizer.native_enabled}
    logger.info(f"test set: {len(test_ds.img_keys)} images / {len(test_ds)} captions; "
                f"native IO {native_io}")

    model = build_model(cfg, args, device)
    if ns.int8_encoder:
        logger.info("encoder: W8A8 int8 QKV and FFN-up projections")
    if payload is not None:
        stats = load_state_dict_report(model, payload["model"])
        logger.info(f"checkpoint: {stats['matched']} params loaded, "
                    f"{len(stats['missing'])} missing, {len(stats['unused'])} unused")
        if stats["missing"]:
            logger.warning(f"missing from checkpoint: {stats['missing'][:8]}...")

    t0 = time.perf_counter()
    buffer_len = max(args.max_seq_length, args.max_img_seq_length) + 1
    img_embs, cap_embs, img_lens, cap_lens = encode_data(model, loader, buffer_len=buffer_len,
                                                         logger=logger)
    _sync(device)
    encode_seconds = time.perf_counter() - t0
    if ns.bucketed_encode:  # rows were visited in length order; restore row order
        inv = np.argsort(loader.row_order(0), kind="stable")
        img_embs, cap_embs = img_embs[inv], cap_embs[inv]
        img_lens, cap_lens = img_lens[inv], cap_lens[inv]

    scoring_dtype = torch.int8 if ns.compute_dtype == "int8" else torch.bfloat16
    if ns.compute_dtype == "int8":
        logger.info("alignment scoring: int8 operands")

    logger.info("Matching head:")
    recall = recall_1k_5fold if ns.fivefold else compute_recall
    m = recall(img_embs[:, 0, :], cap_embs[:, 0, :], device=device)
    logger.info(str({k: round(v, 2) for k, v in m.items()}))

    logger.info("Alignment head:")
    ndcg_scorer = None
    if ns.ndcg:
        ndcg_scorer = build_ndcg_scorer(cfg, args, ns.test_split, len(test_ds))
        logger.info(f"ndcg scorer: {ndcg_scorer.relevance_methods if ndcg_scorer else None}")
    score_fn = None
    if mesh is not None:
        def score_fn(ims, caps, il, cl):
            return sharded_mrsw_scores(mesh, ims, caps, il, cl,
                                       aggregation=cfg.training.alignment_mode,
                                       compute_dtype=scoring_dtype)
    t0 = time.perf_counter()
    i2t, t2i, scores = evaluate_alignment_head(
        img_embs, cap_embs, img_lens, cap_lens, aggregation=cfg.training.alignment_mode,
        compute_dtype=scoring_dtype, device=device, score_fn=score_fn)
    _sync(device)
    t1 = time.perf_counter()
    if ns.fivefold:  # NDCG per fold, at the fold's relevance rows
        i2t, t2i = fivefold_from_scores(scores, ndcg_scorer=ndcg_scorer)
    elif ndcg_scorer is not None:
        for metrics, retrieval in ((i2t, "sentence"), (t2i, "image")):
            metrics["ndcg_rougel"], metrics["ndcg_spice"] = ndcg_from_scores(
                scores, ndcg_scorer, 0, retrieval)
    score_seconds = time.perf_counter() - t0
    ndcg_seconds = time.perf_counter() - t1 if ndcg_scorer is not None else 0.0
    rsum = i2t["r1"] + i2t["r5"] + i2t["r10"] + t2i["r1"] + t2i["r5"] + t2i["r10"]
    logger.info(
        "Alignment i2t %.1f/%.1f/%.1f (medr %.0f) t2i %.1f/%.1f/%.1f (medr %.0f) rsum %.1f "
        "ndcg_rouge %.4f ndcg_spice %.4f"
        % (i2t["r1"], i2t["r5"], i2t["r10"], i2t["medr"],
           t2i["r1"], t2i["r5"], t2i["r10"], t2i["medr"], rsum,
           i2t["ndcg_rougel"] + t2i["ndcg_rougel"], i2t["ndcg_spice"] + t2i["ndcg_spice"]))
    logger.info(f"encode {encode_seconds:.3f} s, alignment scoring {score_seconds:.3f} s "
                f"(ndcg {ndcg_seconds:.3f} s)")
    return {"matching": m, "alignment_i2t": i2t, "alignment_t2i": t2i,
            "scores": scores.cpu().numpy(), "encode_seconds": encode_seconds,
            "score_seconds": score_seconds, "ndcg_seconds": ndcg_seconds,
            "native_io": native_io}


def main(argv=None) -> int:
    run(argv)
    shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
