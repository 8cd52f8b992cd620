"""Day-one parity harness: released checkpoint + COCO paths -> BASELINE diff
(mirrors aladin_tpu/cli/parity.py).

One command that runs the full reference evaluation protocol against the
numbers the reference's headline rests on, and emits a machine- and
human-readable PASS/FAIL report:

    python -m aladin_torch.cli.parity \\
        --data_dir <data>/coco_ir --img_feat_file <feat>/features.tsv \\
        --eval_model_dir <ckpt>/checkpoint-0132780 \\
        --load_checkpoint <model_best_rsum.pth.tar> \\
        --report_dir runs/parity [--device cuda]

Pipeline (all from one encode pass over the 5k test set):
  1. load the checkpoint (a released or port ``.pth.tar``; orbax
     directories are a JAX format and are refused, ``io/checkpoint.py``);
  2. encode the test split once (``eval/encode.py``);
  3. matching + alignment heads on the 5k protocol
     (``test_img_keys.tsv``) and the 5x1k-fold protocol;
  4. matching + alignment heads on the 1k protocol
     (``test_img_keys_1k.tsv``, a subset of the same encode: the encoder is
     per-sample, so subsetting the 5k buffers is exact);
  5. serial per-query latency on the 1k fold (``eval/latency.py``), the
     axes of the reference's efficiency plot.

The alignment head scores with the MrSw kernel (K1) on the card, as
``cli/test`` does; under ``torchrun`` with ``--mesh_shape dp=N[,tp=M]``
the scoring shards the caption axis over every rank
(``parallel/mesh.py::sharded_mrsw_scores``), every rank encodes the whole
split, and rank 0 alone logs and writes the report.

Reference targets (ref:alad/plots/plot_efficiency_vs_effectiveness.py:13-14):
rsum 215.0 (matching head, joint A/ft.+D/ft. model) and 224.0 (alignment
head, A/ft. model) on the 1k protocol; 0.023 s / 0.098 s per query. Which
rsum row GATES (PASS/FAIL vs informational) follows the checkpoint's
loss-type (``--profile auto``); ``--expected_json`` overrides any target.

Exit code: 0, or 1 under ``--strict`` when any gating row fails.
``main(argv)`` returns it.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from aladin_torch.cli.common import (
    add_shared_flags,
    build_model,
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
from aladin_torch.eval.latency import REF_ALIGNMENT_S, REF_MATCHING_S, serial_query_latency
from aladin_torch.eval.recall import compute_recall, recall_1k_5fold
from aladin_torch.eval.retrieval import evaluate_alignment_head, fivefold_from_scores
from aladin_torch.eval.search import build_corpus
from aladin_torch.io.checkpoint import load_checkpoint, load_state_dict_report
from aladin_torch.parallel.distributed import initialize, is_main_process, rank_logger, shutdown
from aladin_torch.parallel.mesh import sharded_mrsw_scores
from aladin_torch.utils.device import resolve_device

#: the BASELINE.md table this harness diffs against
#: (ref:alad/plots/plot_efficiency_vs_effectiveness.py:13-14)
DEFAULT_EXPECTED = {
    "matching_rsum_1k": 215.0,
    "alignment_rsum_1k": 224.0,
    "matching_serial_s_per_query": REF_MATCHING_S,
    "alignment_serial_s_per_query": REF_ALIGNMENT_S,
}


def _rsum(m: Dict[str, float]) -> float:
    return sum(m[k] for k in ("i2t_r1", "i2t_r5", "i2t_r10",
                              "t2i_r1", "t2i_r5", "t2i_r10"))


def _head_metrics(i2t: Dict[str, float], t2i: Dict[str, float]) -> Dict[str, float]:
    out = {f"i2t_{k}": v for k, v in i2t.items() if not k.startswith("ndcg")}
    out.update({f"t2i_{k}": v for k, v in t2i.items() if not k.startswith("ndcg")})
    out["rsum"] = _rsum(out)
    return out


def _subset_rows(img_keys: List[int], ncap: int, keys_path: str, logger):
    """Buffer row indices for the images listed in ``keys_path``.

    Encode-buffer layout: rows [j*ncap, (j+1)*ncap) belong to img_keys[j]
    (data/dataset.py row order), so a key subset is an exact row subset of
    the 5k encode."""
    with open(keys_path) as f:
        keys = [int(line.strip()) for line in f if line.strip()]
    pos = {k: j for j, k in enumerate(img_keys)}
    idx = [pos[k] for k in keys if k in pos]
    if len(idx) < len(keys):
        logger.warning(
            "%s: %d of %d keys not in the encoded split; evaluating the %d "
            "present", keys_path, len(keys) - len(idx), len(keys), len(idx))
    rows = np.concatenate([np.arange(j * ncap, (j + 1) * ncap) for j in idx])
    return rows, len(idx)


def evaluate_protocol(img_embs, cap_embs, img_lens, cap_lens, *, aggregation, scoring_dtype,
                      device, ncap=5, score_fn=None):
    """Both heads over one buffer set -> (matching, alignment, align scores)."""
    matching = compute_recall(img_embs[:, 0, :], cap_embs[:, 0, :], ncap, device=device)
    i2t, t2i, scores = evaluate_alignment_head(
        img_embs, cap_embs, img_lens, cap_lens, aggregation=aggregation,
        captions_per_image=ncap, compute_dtype=scoring_dtype, device=device,
        score_fn=score_fn)
    return matching, _head_metrics(i2t, t2i), scores


def _parse(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="ALADIN parity harness (PyTorch): checkpoint + data -> BASELINE.md diff")
    add_shared_flags(parser)
    parser.add_argument("--load_checkpoint", default="",
                        help="released or port .pth.tar")
    parser.add_argument("--report_dir", default="",
                        help="where parity_report.{json,md} land "
                             "(default: --logger_name)")
    parser.add_argument("--keys_5k_file", default="test_img_keys.tsv")
    parser.add_argument("--keys_1k_file", default="test_img_keys_1k.tsv")
    parser.add_argument("--skip_latency", action="store_true",
                        help="skip the serial per-query latency section")
    parser.add_argument("--latency_serial", type=int, default=64,
                        help="queries per serial-latency scan")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 when any gating check fails")
    parser.add_argument("--rsum_tol", type=float, default=2.0,
                        help="rsum points below the reference target that "
                             "still PASS (R@K variance across retrainings)")
    parser.add_argument("--profile", default="auto",
                        choices=["auto", "joint", "alignment-ft", "none"],
                        help="which BASELINE rsum row gates: joint = "
                             "matching-head 215.0, alignment-ft = "
                             "alignment-head 224.0; auto = infer from the "
                             "checkpoint's loss-type; none = all rows "
                             "informational")
    parser.add_argument("--expected_json", default="",
                        help="JSON file overriding the expected targets "
                             "(keys of DEFAULT_EXPECTED); every key present "
                             "gates regardless of --profile")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    code = run(argv)["exit_code"]
    shutdown()
    return code


def run(argv=None) -> dict:
    """The harness; returns {"report", "exit_code", "scores_5k" (the 5k
    alignment matrix on the host), "encode_seconds", "score_seconds" (both
    heads over the three protocols), "latency_seconds" (the serial
    latency section)}."""
    ns = _parse(argv)
    args = to_data_args(ns)
    device = resolve_device(ns.device)
    initialize(device=device.type)
    mesh = maybe_create_mesh(args.mesh_shape, device)
    report_dir = ns.report_dir or args.logger_name
    if is_main_process():
        os.makedirs(report_dir, exist_ok=True)
    logger = rank_logger(report_dir)

    # ---- 1. checkpoint + config (exactly cli/test's resolution) -----------
    cfg_dict = None
    payload = None
    if ns.load_checkpoint:
        payload, cfg_dict = load_checkpoint(ns.load_checkpoint)
    if cfg_dict:
        cfg = ExperimentConfig.from_dict(cfg_dict)
    else:
        if not ns.config:
            raise ValueError("need --config when the checkpoint has no embedded config")
        cfg = load_config(ns.config)
    d = cfg.to_dict()
    d["training"]["loss-type"] = "alignment-distillation"  # eval BOTH heads
    profile_loss = (cfg_dict or cfg.to_dict())["training"]["loss-type"]
    cfg = ExperimentConfig.from_dict(d)

    if args.synthetic:
        args = prepare_synthetic(args)
    args = restore_training_settings(args)

    # ---- 2. dataset: the 5k protocol keys file when present ---------------
    if not args.eval_img_keys_file and os.path.exists(
            os.path.join(args.data_dir, ns.keys_5k_file)):
        args.eval_img_keys_file = ns.keys_5k_file
    tokenizer = build_tokenizer(args)
    test_ds = RetrievalDataset(tokenizer, args, "test", is_train=False)
    loader = BatchLoader(test_ds, cfg.training.bs, shuffle=False, drop_last=False,
                         device=device, num_threads=args.num_workers)
    ncap = test_ds.num_captions_per_img
    logger.info(f"test set: {len(test_ds.img_keys)} images / {len(test_ds)} captions")

    model = build_model(cfg, args, device)
    if payload is not None:
        stats = load_state_dict_report(model, payload["model"])
        logger.info(
            f"checkpoint: {stats['matched']} params loaded, "
            f"{len(stats['missing'])} missing, {len(stats['unused'])} unused")
        coverage = {"matched": stats["matched"],
                    "missing": len(stats["missing"]),
                    "unused": len(stats["unused"])}
    else:
        logger.warning("no --load_checkpoint: evaluating a RANDOM model")
        coverage = None

    # ---- 3. one encode pass over the 5k set -------------------------------
    t0 = time.perf_counter()
    buffer_len = max(args.max_seq_length, args.max_img_seq_length) + 1
    img_embs, cap_embs, img_lens, cap_lens = encode_data(model, loader, buffer_len=buffer_len,
                                                         logger=logger)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    encode_seconds = time.perf_counter() - t0

    scoring_dtype = torch.int8 if ns.compute_dtype == "int8" else torch.bfloat16
    score_fn = None
    if mesh is not None:
        def score_fn(ims, caps, il, cl):
            return sharded_mrsw_scores(mesh, ims, caps, il, cl,
                                       aggregation=cfg.training.alignment_mode,
                                       compute_dtype=scoring_dtype)

    kw = dict(aggregation=cfg.training.alignment_mode, scoring_dtype=scoring_dtype,
              device=device, ncap=ncap, score_fn=score_fn)

    results: Dict[str, Dict[str, float]] = {}
    t0 = time.perf_counter()
    logger.info("5k protocol:")
    match_5k, align_5k, scores_5k = evaluate_protocol(
        img_embs, cap_embs, img_lens, cap_lens, **kw)
    results["matching_5k"], results["alignment_5k"] = match_5k, align_5k

    logger.info("5x1k-fold protocol:")
    results["matching_5fold"] = recall_1k_5fold(img_embs[:, 0, :], cap_embs[:, 0, :],
                                                device=device)
    ff_i2t, ff_t2i = fivefold_from_scores(scores_5k, ncap)
    results["alignment_5fold"] = _head_metrics(ff_i2t, ff_t2i)
    scores_5k = scores_5k.float().cpu().numpy()

    # ---- 4. the 1k protocol: exact subset of the same encode --------------
    keys_1k_path = os.path.join(args.data_dir, ns.keys_1k_file)
    n_1k = 0
    rows_1k = None
    if os.path.exists(keys_1k_path):
        rows_1k, n_1k = _subset_rows(test_ds.img_keys, ncap, keys_1k_path, logger)
        logger.info(f"1k protocol ({n_1k} images):")
        match_1k, align_1k, _ = evaluate_protocol(
            img_embs[rows_1k], cap_embs[rows_1k],
            img_lens[rows_1k], cap_lens[rows_1k], **kw)
        results["matching_1k"], results["alignment_1k"] = match_1k, align_1k
    else:
        logger.warning(f"{keys_1k_path} not found; skipping the 1k protocol "
                       "(BASELINE rsum rows will gate on the 5-fold numbers)")
        results["matching_1k"] = results["matching_5fold"]
        results["alignment_1k"] = results["alignment_5fold"]
    score_seconds = time.perf_counter() - t0

    # ---- 5. serial per-query latency on the 1k fold -----------------------
    latency: Dict[str, Optional[float]] = {}
    t0 = time.perf_counter()
    if not ns.skip_latency:
        r = rows_1k if rows_1k is not None else np.arange(len(img_lens))
        corpus = build_corpus(img_embs[r][::ncap], img_lens[r][::ncap], device=device)
        q, ql = cap_embs[r], cap_lens[r]
        n_serial = min(ns.latency_serial, q.shape[0])
        for mode, key in (("matching", "matching_serial_s_per_query"),
                          ("two_stage", "two_stage_serial_s_per_query"),
                          ("full_alignment", "alignment_serial_s_per_query")):
            s_per_q, note = serial_query_latency(
                corpus, q, ql, mode=mode, n_serial=n_serial,
                aggregation=cfg.training.alignment_mode)
            latency[key] = s_per_q
            if note:
                latency[key + "_note"] = note
            logger.info(f"latency {mode}: "
                        f"{s_per_q if s_per_q is None else round(s_per_q, 6)} "
                        f"s/query {note}")
    latency_seconds = time.perf_counter() - t0

    # ---- 6. the diff: PASS/FAIL vs the reference targets ------------------
    expected = dict(DEFAULT_EXPECTED)
    override_keys = set()
    if ns.expected_json:
        with open(ns.expected_json) as f:
            override = json.load(f)
        expected.update(override)
        override_keys = set(override)

    profile = ns.profile
    if profile == "auto":
        # the released best model is the joint recipe (loss-type
        # alignment-distillation, ref:alad/README.md:89); a pure-alignment
        # loss means the A/ft. 224.0 row is the relevant target
        parts = set(str(profile_loss).split("-"))
        profile = "joint" if parts & {"distillation", "matching"} else "alignment-ft"
    gates = {"joint": {"matching_rsum_1k"},
             "alignment-ft": {"alignment_rsum_1k"},
             "none": set()}[profile]
    if not ns.skip_latency:
        gates = gates | {"matching_serial_s_per_query",
                         "alignment_serial_s_per_query"}
    gates |= override_keys

    measured = {
        "matching_rsum_1k": results["matching_1k"]["rsum"],
        "alignment_rsum_1k": results["alignment_1k"]["rsum"],
        "matching_serial_s_per_query": latency.get("matching_serial_s_per_query"),
        "alignment_serial_s_per_query": latency.get("alignment_serial_s_per_query"),
    }
    checks = []
    for key, target in expected.items():
        ours = measured.get(key)
        if ours is None:
            status = "SKIPPED" if key not in gates else "FAIL"
            if key.endswith("s_per_query") and key in latency:
                status = "PASS"  # measured below the clock's floor: faster
                ours = latency.get(key)
        elif key.endswith("rsum_1k"):
            status = "PASS" if ours >= target - ns.rsum_tol else "FAIL"
        else:  # latency: lower is better
            status = "PASS" if ours <= target else "FAIL"
        if key not in gates and status in ("PASS", "FAIL"):
            status = f"INFO-{status}"
        checks.append({"check": key, "ours": ours, "reference": target,
                       "status": status})

    failed = [c for c in checks if c["status"] == "FAIL"]
    report = {
        "checkpoint": ns.load_checkpoint,
        "profile": profile,
        "loss_type": profile_loss,
        "coverage": coverage,
        "n_images_5k": len(test_ds.img_keys),
        "n_images_1k": n_1k,
        "results": results,
        "latency": latency,
        "checks": checks,
        "pass": not failed,
    }
    if is_main_process():
        jpath = os.path.join(report_dir, "parity_report.json")
        with open(jpath, "w") as f:
            json.dump(report, f, indent=2)
        mpath = os.path.join(report_dir, "parity_report.md")
        with open(mpath, "w") as f:
            f.write(_markdown(report, ns))
        logger.info(f"report: {jpath} / {mpath}")
    for c in checks:
        logger.info(f"  {c['check']}: ours={c['ours']} "
                    f"ref={c['reference']} -> {c['status']}")
    code = 0
    if failed:
        logger.warning(f"{len(failed)} gating check(s) FAILED")
        code = 1 if ns.strict else 0
    else:
        logger.info("all gating checks passed")
    return {"report": report, "exit_code": code, "scores_5k": scores_5k,
            "encode_seconds": encode_seconds, "score_seconds": score_seconds,
            "latency_seconds": latency_seconds}


def _markdown(report: dict, ns) -> str:
    lines = [
        "# ALADIN parity report",
        "",
        f"- checkpoint: `{report['checkpoint'] or '(random init)'}`",
        f"- loss-type: `{report['loss_type']}` -> profile `{report['profile']}`",
        f"- test set: {report['n_images_5k']} images (1k subset: "
        f"{report['n_images_1k'] or 'n/a'})",
    ]
    if report["coverage"]:
        c = report["coverage"]
        lines.append(f"- checkpoint coverage: {c['matched']} loaded / "
                     f"{c['missing']} missing / {c['unused']} unused")
    lines += ["", "## Gating checks vs BASELINE.md "
              "(ref alad/plots/plot_efficiency_vs_effectiveness.py:13-14)", "",
              "| check | ours | reference | status |", "|---|---|---|---|"]
    for c in report["checks"]:
        ours = "n/a" if c["ours"] is None else (
            f"{c['ours']:.4f}" if c["ours"] < 10 else f"{c['ours']:.1f}")
        lines.append(f"| {c['check']} | {ours} | {c['reference']} | "
                     f"{c['status']} |")
    lines += ["", f"rsum tolerance: -{ns.rsum_tol}; latency passes at or "
              "under the reference point.", "", "## Full metrics", ""]
    for proto, m in report["results"].items():
        row = " ".join(f"{k}={v:.2f}" for k, v in sorted(m.items()))
        lines.append(f"- **{proto}**: {row}")
    if report["latency"]:
        lines += ["", "## Serial per-query latency (s)", ""]
        for k, v in report["latency"].items():
            lines.append(f"- {k}: {v if isinstance(v, str) or v is None else round(v, 6)}")
    lines += ["", f"**Overall: {'PASS' if report['pass'] else 'FAIL'}**", ""]
    return "\n".join(lines)


if __name__ == "__main__":
    raise SystemExit(main())
