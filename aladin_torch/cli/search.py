"""Retrieval search CLI: build a persisted index, serve queries, measure the
retrieve-and-rerank quality curve (mirrors aladin_tpu/cli/search.py).

  build   checkpoint + dataset -> one encode pass -> persisted index dir
          (embeddings.npz + index_meta.json, eval/index.py)
  query   free-text (t2i) or by-row queries against a loaded index;
          one-shot, batch-file, or interactive
  curve   recall@k vs shortlist size, the quality axis of the
          retrieve-and-rerank trade-off, with the matching-only floor and
          the full-rerank ceiling

Every subcommand runs on the card unless ``--device cpu`` is given. An
index either package writes loads in the other. ``query`` and ``curve``
take ``--mesh_shape dp=N[,tp=M]`` under ``torchrun``: the corpus is
sharded over every rank, dp and tp alike (``eval/search.py::
sharded_search``; the queries encode unsharded) and rank 0 prints and
writes; ``build`` encodes on one process.

    python -m aladin_torch.cli.search build --index_dir idx/ \\
        --load_checkpoint model_best_rsum.pth.tar --data_dir coco_ir ...
    python -m aladin_torch.cli.search query --index_dir idx/ \\
        --text "a dog catching a frisbee" --k 5
    python -m aladin_torch.cli.search curve --index_dir idx/ \\
        --shortlists 10,25,50,100 --out curve.json

``run(argv)`` returns what the subcommand computed; ``main(argv)`` returns
the exit code (2 for an index that cannot be used as it is).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, List, Tuple

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
from aladin_torch.config import DataArgs, ExperimentConfig, load_config
from aladin_torch.data.dataset import DisentangledTensorizer, RetrievalDataset
from aladin_torch.data.pipeline import BatchLoader, batch_from_numpy
from aladin_torch.eval.encode import encode_data
from aladin_torch.eval.index import IndexCompatError, SearchIndex, load_index, save_index
from aladin_torch.eval.search import search, sharded_search
from aladin_torch.io.checkpoint import load_checkpoint, load_state_dict_report
from aladin_torch.parallel.distributed import initialize, is_main_process
from aladin_torch.utils.device import resolve_device
from aladin_torch.utils.logging import setup_logger

QUERY_CHUNK = 8  # captions per query-encode batch


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="aladin_torch.cli.search",
                                description="retrieval search CLI (PyTorch)")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="encode a dataset split into an index dir")
    add_shared_flags(b)
    b.add_argument("--index_dir", required=True)
    b.add_argument("--load_checkpoint", default="", help="released .pth.tar")
    b.add_argument("--test_split", default="test")
    b.add_argument("--bucketed_encode", action="store_true",
                   help="length-sorted, length-trimmed encode batches")
    b.add_argument("--store_dtype", default="float16", choices=["float16", "float32"])

    q = sub.add_parser("query", help="search a built index")
    q.add_argument("--index_dir", required=True)
    q.add_argument("--direction", default="t2i", choices=["t2i", "i2t"])
    q.add_argument("--text", action="append", default=[],
                   help="free-text query (repeatable; t2i only)")
    q.add_argument("--queries_file", default="",
                   help="file with one free-text query per line (t2i only)")
    q.add_argument("--query_index", action="append", type=int, default=[],
                   help="use an index row as the query (caption row for t2i, image row for "
                        "i2t; repeatable)")
    q.add_argument("--interactive", action="store_true",
                   help="read queries from stdin, one per line (t2i)")
    q.add_argument("--k", type=int, default=10)
    q.add_argument("--shortlist", type=int, default=100)
    q.add_argument("--no_rerank", action="store_true",
                   help="matching head only (the 0.023 s/query operating point of the "
                        "reference plot)")
    q.add_argument("--mesh_shape", default="",
                   help="e.g. dp=8 or dp=4,tp=2 under torchrun: shard the corpus over "
                        "every rank (sharded_search's distributed top-k merge)")
    q.add_argument("--load_checkpoint", default="",
                   help="override the checkpoint recorded in the index")
    q.add_argument("--out", default="", help="also write results JSON here")
    q.add_argument("--device", default="cuda",
                   help="torch device; needs CUDA unless this is 'cpu'")

    c = sub.add_parser("curve", help="recall@k vs shortlist quality curve")
    c.add_argument("--index_dir", required=True)
    c.add_argument("--direction", default="both", choices=["both", "t2i", "i2t"])
    c.add_argument("--ks", default="1,5,10")
    c.add_argument("--shortlists", default="5,10,25,50,100")
    c.add_argument("--mesh_shape", default="", help="as query's")
    c.add_argument("--out", default="", help="write the curve JSON here")
    c.add_argument("--device", default="cuda",
                   help="torch device; needs CUDA unless this is 'cpu'")
    return p


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _cmd_build(ns) -> Dict[str, Any]:
    t_start = time.perf_counter()
    args = to_data_args(ns)
    device = resolve_device(ns.device)
    logger = setup_logger("vlpretrain", args.logger_name)

    cfg_dict, payload = None, None
    if ns.load_checkpoint:
        payload, cfg_dict = load_checkpoint(ns.load_checkpoint)
    if cfg_dict:
        cfg = ExperimentConfig.from_dict(cfg_dict)
    elif ns.config:
        cfg = load_config(ns.config)
    else:
        raise ValueError("need --config when the checkpoint has no embedded config")

    if args.synthetic:
        args = prepare_synthetic(args)
    args = restore_training_settings(args)

    tokenizer = build_tokenizer(args)
    ds = RetrievalDataset(tokenizer, args, ns.test_split, is_train=False)
    loader = BatchLoader(ds, cfg.training.bs, shuffle=False, drop_last=False, device=device,
                         sort_by_length=ns.bucketed_encode,
                         trim_multiple=16 if ns.bucketed_encode else 0)
    logger.info(f"index build: {len(ds.img_keys)} images / {len(ds)} captions")

    model = build_model(cfg, args, device)
    if payload is not None:
        stats = load_state_dict_report(model, payload["model"])
        logger.info(f"checkpoint: {stats['matched']} params loaded")
        if stats["matched"] == 0:
            raise ValueError(f"{ns.load_checkpoint}: no parameter matched the model")

    t0 = time.perf_counter()
    buffer_len = max(args.max_seq_length, args.max_img_seq_length) + 1
    img_embs, cap_embs, img_lens, cap_lens = encode_data(model, loader, buffer_len=buffer_len,
                                                         logger=logger)
    encode_seconds = time.perf_counter() - t0
    if ns.bucketed_encode:  # rows were visited in length order; restore row order
        inv = np.argsort(loader.row_order(0), kind="stable")
        img_embs, cap_embs = img_embs[inv], cap_embs[inv]
        img_lens, cap_lens = img_lens[inv], cap_lens[inv]

    cpi = len(ds) // max(len(ds.img_keys), 1)
    captions = []
    for i in range(len(ds)):
        _, (cap_key, cap_idx) = ds.get_image_caption_index(i)
        captions.append(ds.captions[cap_key][cap_idx])
    meta = {
        "config": cfg.to_dict(),
        "args": dataclasses.asdict(args),
        "checkpoint": ns.load_checkpoint,
        "split": ns.test_split,
        # int where possible (COCO ids), str otherwise (open-images hashes)
        "img_keys": [int(k) if str(k).lstrip("-").isdigit() else str(k) for k in ds.img_keys],
        "captions": captions,
    }
    save_index(ns.index_dir, img_embs, cap_embs, img_lens, cap_lens, meta,
               captions_per_img=cpi, store_dtype=ns.store_dtype)
    seconds = time.perf_counter() - t_start
    logger.info(f"index written: {ns.index_dir} ({len(ds.img_keys)} images, {len(ds)} captions, "
                f"store={ns.store_dtype}; encode {encode_seconds:.3f} s of {seconds:.3f} s)")
    return {"index_dir": ns.index_dir, "encode_seconds": encode_seconds, "seconds": seconds}


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------


def _make_text_encoder(index: SearchIndex, device: torch.device, checkpoint_override: str = ""):
    """Query-time caption encoder from the metadata the index recorded: the
    same tokenizer, model construction and checkpoint (or the same seed for
    synthetic runs), so query embeddings live in the corpus space. Returns
    texts -> (sets (Q, S, D) slot-0-packed, lens)."""
    meta = index.meta
    args = DataArgs(**meta["args"])
    cfg = ExperimentConfig.from_dict(meta["config"])
    tokenizer = build_tokenizer(args)
    tensorizer = DisentangledTensorizer(tokenizer, args.max_seq_length, args.max_img_seq_length,
                                        img_feature_dim=args.img_feature_dim)
    # a 2-region dummy image rides along (the model is two-tower; only the
    # caption outputs are read)
    dummy_feats = np.zeros((2, args.img_feature_dim), np.float32)

    def tensorize_batch(texts: List[str]):
        ex = [tensorizer.tensorize(t, None, dummy_feats) for t in texts]
        d = {
            "txt_ids": np.stack([e.txt_ids for e in ex]),
            "txt_mask": np.stack([e.txt_mask for e in ex]),
            "txt_type": np.stack([e.txt_type for e in ex]),
            "cap_len": np.asarray([e.cap_len for e in ex], np.int32),
            "img_ids": np.stack([e.img_ids for e in ex]),
            "img_mask": np.stack([e.img_mask for e in ex]),
            "img_type": np.stack([e.img_type for e in ex]),
            "img_feats": np.stack([e.img_feats for e in ex]),
            "img_len": np.asarray([e.img_len for e in ex], np.int32),
        }
        return batch_from_numpy(d, device)

    model = build_model(cfg, args, device)
    ckpt = checkpoint_override or meta.get("checkpoint", "")
    if ckpt:
        payload, _ = load_checkpoint(ckpt)
        if load_state_dict_report(model, payload["model"])["matched"] == 0:
            raise ValueError(f"{ckpt}: no parameter matched the model")
    elif not args.synthetic:
        raise ValueError("index records no checkpoint and is not synthetic; pass "
                         "--load_checkpoint to define the query encoder")

    def encode_texts(texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        sets_out, lens_out = [], []
        for lo in range(0, len(texts), QUERY_CHUNK):
            chunk = texts[lo:lo + QUERY_CHUNK]
            pad = QUERY_CHUNK - len(chunk)
            with torch.inference_mode():
                out = model(tensorize_batch(chunk + ["pad"] * pad))
            buf = out.cap_seq.float().cpu().numpy()
            # slot-0 global packing, as in eval/encode.py (alignment scoring
            # strips slot 0, so the CLS token row is expendable)
            buf[:, 0] = out.cap_global.float().cpu().numpy()
            sets_out.append(buf[:len(chunk)])
            lens_out.extend(out.cap_len.cpu().tolist()[:len(chunk)])
        return np.concatenate(sets_out), np.asarray(lens_out, np.int32)

    return encode_texts


def _maybe_mesh(mesh_shape: str, device):
    """A mesh over the process group for a non-empty ``--mesh_shape`` that
    spans more than one rank, else None."""
    if not mesh_shape:
        return None
    initialize(device=device.type)
    return maybe_create_mesh(mesh_shape, device)


def _say(*args, **kw) -> None:
    """print, on the main process only."""
    if is_main_process():
        print(*args, **kw)


def _run_search(index: SearchIndex, corpora: Dict[str, Any], device, mesh, q_sets, q_lens, *,
                direction, k, shortlist, rerank, aggregation):
    modality = "image" if direction == "t2i" else "caption"
    if modality not in corpora:  # each corpus goes to the device once per command
        corpora[modality] = index.corpus(modality, device)
    if mesh is not None:
        return sharded_search(mesh, corpora[modality], q_sets, q_lens, direction=direction, k=k,
                              shortlist=shortlist, rerank=rerank, aggregation=aggregation)
    return search(corpora[modality], q_sets, q_lens, direction=direction, k=k,
                  shortlist=shortlist, rerank=rerank, aggregation=aggregation)


def _format_hits(index: SearchIndex, direction: str, scores_row, idx_row) -> List[dict]:
    hits = []
    for score, j in zip(scores_row.tolist(), idx_row.tolist()):
        if direction == "t2i":
            hits.append({"rank": len(hits) + 1, "score": round(score, 4),
                         "image_key": index.meta["img_keys"][j]})
        else:
            cpi = index.captions_per_img
            hits.append({"rank": len(hits) + 1, "score": round(score, 4),
                         "caption": index.meta["captions"][j],
                         "image_key": index.meta["img_keys"][j // cpi]})
    return hits


def _cmd_query(ns) -> List[dict]:
    device = resolve_device(ns.device)
    mesh = _maybe_mesh(ns.mesh_shape, device)
    index = load_index(ns.index_dir)
    agg = index.meta["config"]["training"].get("alignment-mode", "MrSw")
    rerank = not ns.no_rerank
    corpora: Dict[str, Any] = {}
    results = []

    texts: List[str] = list(ns.text)
    if ns.queries_file:
        with open(ns.queries_file) as f:
            texts += [line.strip() for line in f if line.strip()]
    if texts and ns.direction != "t2i":
        raise SystemExit("free-text queries are t2i (text -> images); use --query_index for i2t")

    encode_texts = None
    if texts or ns.interactive:
        encode_texts = _make_text_encoder(index, device, ns.load_checkpoint)

    def run_and_print(batch_texts=None, rows=None):
        if batch_texts is not None:
            q_sets, q_lens = encode_texts(batch_texts)
            labels = batch_texts
        else:
            modality = "caption" if ns.direction == "t2i" else "image"
            sets, lens = index.query_buffers(modality)
            q_sets, q_lens = sets[rows], lens[rows]
            labels = [f"{modality}[{r}]" for r in rows]
        scores, idx = _run_search(index, corpora, device, mesh, q_sets, q_lens,
                                  direction=ns.direction, k=ns.k, shortlist=ns.shortlist,
                                  rerank=rerank, aggregation=agg)
        for qi, label in enumerate(labels):
            hits = _format_hits(index, ns.direction, scores[qi], idx[qi])
            results.append({"query": label, "hits": hits})
            _say(f"query: {label}")
            for h in hits:
                tail = (f"image {h['image_key']}" if ns.direction == "t2i"
                        else f"image {h['image_key']}: {h['caption']}")
                _say(f"  {h['rank']:>3}. {h['score']:+.4f}  {tail}")

    if texts:
        run_and_print(batch_texts=texts)
    if ns.query_index:
        run_and_print(rows=np.asarray(ns.query_index, np.int64))
    if ns.interactive:
        print("interactive search (one query per line, EOF/empty to exit)")
        for line in sys.stdin:
            line = line.strip()
            if not line:
                break
            run_and_print(batch_texts=[line])
    if not (texts or ns.query_index or ns.interactive):
        raise SystemExit("no queries: pass --text / --queries_file / --query_index / "
                         "--interactive")
    if ns.out and is_main_process():
        with open(ns.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


# ---------------------------------------------------------------------------
# curve
# ---------------------------------------------------------------------------


def _recall_at(idx: np.ndarray, direction: str, cpi: int, ks: List[int]):
    """GT from the dataset's cpi-captions-per-image pairing: caption q's
    image is q // cpi (t2i); image q's captions are the rows with
    j // cpi == q, ranked by the best of the group."""
    q = np.arange(idx.shape[0])
    if direction == "t2i":
        hit = idx == (q // cpi)[:, None]
    else:
        hit = (idx // cpi) == q[:, None]
    # a shortlist smaller than k returns fewer than k results; recall@k is
    # then the recall over everything the pipeline returned
    return {k: round(float(hit[:, :min(k, idx.shape[1])].any(axis=1).mean()) * 100.0, 2)
            for k in ks}


def _cmd_curve(ns) -> Dict[str, Any]:
    device = resolve_device(ns.device)
    mesh = _maybe_mesh(ns.mesh_shape, device)
    index = load_index(ns.index_dir)
    agg = index.meta["config"]["training"].get("alignment-mode", "MrSw")
    ks = sorted(int(k) for k in ns.ks.split(","))
    shortlists = sorted(int(s) for s in ns.shortlists.split(","))
    directions = ["t2i", "i2t"] if ns.direction == "both" else [ns.direction]
    cpi = index.captions_per_img
    k_max = max(ks)
    corpora: Dict[str, Any] = {}

    table = {"ks": ks, "captions_per_img": cpi, "rows": []}
    for direction in directions:
        modality = "caption" if direction == "t2i" else "image"
        q_sets, q_lens = index.query_buffers(modality)
        corpus_n = index.n_images if direction == "t2i" else index.n_captions

        def row(name, shortlist, rerank):
            _, idx = _run_search(index, corpora, device, mesh, q_sets, q_lens,
                                 direction=direction,
                                 k=k_max, shortlist=shortlist, rerank=rerank, aggregation=agg)
            r = _recall_at(idx, direction, cpi, ks)
            table["rows"].append({"direction": direction, "stage": name,
                                  "shortlist": shortlist if rerank else None, "recall": r})
            _say(f"{direction}  {name:<16} " + "  ".join(f"R@{k}={r[k]:5.1f}" for k in ks))

        row("matching-only", corpus_n, rerank=False)
        seen = set()
        for s in shortlists:
            s = min(s, corpus_n)
            if s in seen or s >= corpus_n:
                continue
            seen.add(s)
            row(f"rerank@{s}", s, rerank=True)
        row("full-rerank", corpus_n, rerank=True)

    if ns.out and is_main_process():
        with open(ns.out, "w") as f:
            json.dump(table, f, indent=2)
        print(f"curve written: {ns.out}")
    return table


def run(argv=None):
    """Run one subcommand: build returns {"index_dir", "encode_seconds",
    "seconds"}, query its results, curve its table."""
    ns = _build_parser().parse_args(argv)
    if ns.cmd == "build":
        if maybe_create_mesh(ns.mesh_shape, resolve_device(ns.device)) is not None:
            raise ValueError("build encodes on one process; run it without torchrun")
        return _cmd_build(ns)
    if ns.cmd == "query":
        return _cmd_query(ns)
    return _cmd_curve(ns)


def main(argv=None) -> int:
    try:
        run(argv)
    except IndexCompatError as e:
        # a stale, foreign or corrupt index: a clear refusal, not a traceback
        # (and never a silent garbage ranking)
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
