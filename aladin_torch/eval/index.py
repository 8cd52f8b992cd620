"""On-disk search index: persisted encode buffers + metadata (a copy of
aladin_tpu/eval/index.py; only :meth:`SearchIndex.corpus` differs, building
the port's ``Corpus`` on an explicit device).

The deploy-time artifact behind cli/search: one ``build`` pass over a
dataset + checkpoint produces this directory, after which queries never
touch the dataset or re-encode the corpus.

Layout: ``<dir>/embeddings.npz`` (token-set buffers with the slot-0 global
packing of eval/encode.py, images deduplicated to one row per image) +
``<dir>/index_meta.json`` (experiment config, data args, checkpoint path,
image keys, caption texts: everything query time needs to rebuild the
query encoder and to print readable results). The format is the same byte
for byte in both packages: an index either one writes loads in the other.

Token sets store float16 by default: the device-side corpus is bf16 anyway
(eval/search.build_corpus), and fp16's extra mantissa over bf16 makes the
f16 -> bf16 hop benign for L2-normalized embeddings. Slot-0 globals are
kept separately in f32 so stage-1 scoring precision never degrades.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

META_NAME = "index_meta.json"
NPZ_NAME = "embeddings.npz"

# Bump when the on-disk layout changes shape (npz keys, packing convention,
# meta schema). load_index refuses other versions with a rebuild message
# instead of silently mis-ranking.
FORMAT_VERSION = 1

_NPZ_KEYS = ("img_sets", "img_lens", "cap_sets", "cap_lens", "img_glob", "cap_glob")


class IndexCompatError(RuntimeError):
    """A persisted index cannot be used as-is (wrong version, mixed
    artifacts, or corrupt files). The message says how to recover."""


def index_fingerprint(meta: Dict) -> str:
    """Identity of everything that determines the embedding space: model
    config, tensorize args, checkpoint, split, and row counts. Stored in
    BOTH index_meta.json and embeddings.npz so a mixed artifact (meta from
    one build, npz from another — e.g. a partially overwritten index dir)
    is caught at load instead of silently mis-ranking."""
    ident = {
        "config": meta.get("config"),
        "args": meta.get("args"),
        "checkpoint": meta.get("checkpoint"),
        "split": meta.get("split"),
        "store_dtype": meta.get("store_dtype"),
        "n_images": meta.get("n_images"),
        "n_captions": meta.get("n_captions"),
    }
    blob = json.dumps(ident, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


@dataclass
class SearchIndex:
    """Host-side view of a persisted index (numpy; device placement happens
    in :meth:`corpus`)."""

    img_sets: np.ndarray  # (N_img, S, D) deduped, slot-0 global packing
    img_lens: np.ndarray  # (N_img,)
    cap_sets: np.ndarray  # (N_cap, S, D)
    cap_lens: np.ndarray  # (N_cap,)
    img_glob: np.ndarray  # (N_img, D) f32 slot-0 rows
    cap_glob: np.ndarray  # (N_cap, D) f32
    meta: Dict

    @property
    def n_images(self) -> int:
        return self.img_sets.shape[0]

    @property
    def n_captions(self) -> int:
        return self.cap_sets.shape[0]

    @property
    def captions_per_img(self) -> int:
        return int(self.meta.get("captions_per_img", 5))

    def corpus(self, modality: str, device="cuda"):
        """:class:`~aladin_torch.eval.search.Corpus` of one modality
        ('image' for t2i search, 'caption' for i2t) on ``device``."""
        import torch

        from aladin_torch.eval.search import Corpus, normalize_globals
        from aladin_torch.ops.similarity import l2norm

        if modality == "image":
            sets, lens, glob = self.img_sets, self.img_lens, self.img_glob
        elif modality == "caption":
            sets, lens, glob = self.cap_sets, self.cap_lens, self.cap_glob
        else:
            raise ValueError(f"modality must be 'image' or 'caption', got {modality!r}")
        sets = torch.as_tensor(sets, dtype=torch.float32, device=device)
        sets = l2norm(sets, eps=1e-12).to(torch.bfloat16)
        glob = normalize_globals(torch.as_tensor(glob, device=device))
        return Corpus(sets, glob, torch.as_tensor(lens, dtype=torch.int32, device=device))

    def query_buffers(self, modality: str):
        """(sets, lens) numpy buffers for using index ROWS as queries (the
        curve harness and --query_index; slot-0 packing preserved, f32)."""
        if modality == "image":
            sets = self.img_sets.astype(np.float32)
            sets[:, 0, :] = self.img_glob
            return sets, self.img_lens
        if modality == "caption":
            sets = self.cap_sets.astype(np.float32)
            sets[:, 0, :] = self.cap_glob
            return sets, self.cap_lens
        raise ValueError(f"modality must be 'image' or 'caption', got {modality!r}")


def save_index(
    out_dir: str,
    img_embs: np.ndarray,
    cap_embs: np.ndarray,
    img_lens,
    cap_lens,
    meta: Dict,
    captions_per_img: int = 5,
    store_dtype: str = "float16",
) -> str:
    """Persist eval/encode.py buffers as a search index.

    ``img_embs``/``cap_embs`` are the raw (N_rows, S, D) encode buffers with
    images repeated per caption (the reference's row layout,
    ref:alad/evaluation.py:104-155); images deduplicate here to one row per
    image (row ``i*cpi``, the same convention recall_auxiliary assumes,
    ref:alad/recall_auxiliary.py:14-15).
    """
    os.makedirs(out_dir, exist_ok=True)
    cpi = captions_per_img
    assert img_embs.shape[0] == cap_embs.shape[0], "row-aligned buffers required"
    img_sets = np.ascontiguousarray(img_embs[::cpi])
    img_l = np.asarray(img_lens)[::cpi].astype(np.int32)
    dt = np.dtype(store_dtype)
    meta = dict(meta)
    meta["captions_per_img"] = cpi
    meta["store_dtype"] = store_dtype
    meta["n_images"] = int(img_sets.shape[0])
    meta["n_captions"] = int(cap_embs.shape[0])
    meta["format_version"] = FORMAT_VERSION
    fp = index_fingerprint(meta)
    meta["fingerprint"] = fp
    np.savez_compressed(
        os.path.join(out_dir, NPZ_NAME),
        img_sets=img_sets.astype(dt),
        cap_sets=cap_embs.astype(dt),
        img_lens=img_l,
        cap_lens=np.asarray(cap_lens, np.int32),
        img_glob=img_sets[:, 0, :].astype(np.float32),
        cap_glob=np.asarray(cap_embs[:, 0, :], np.float32),
        fingerprint=np.frombuffer(fp.encode(), np.uint8).copy(),
    )
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def load_index(index_dir: str) -> SearchIndex:
    """Load + validate a persisted index.

    Refuses (IndexCompatError, with a recovery hint) rather than silently
    mis-ranking when: the layout version is missing/unsupported, the npz is
    corrupt/truncated/missing buffers, the npz and meta disagree on row
    counts, or the npz fingerprint does not match the meta's (mixed
    artifacts from different builds)."""
    meta_path = os.path.join(index_dir, META_NAME)
    npz_path = os.path.join(index_dir, NPZ_NAME)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise IndexCompatError(f"not a search index: {meta_path} is missing")
    except json.JSONDecodeError as e:
        raise IndexCompatError(
            f"corrupt index metadata {meta_path} ({e}); rebuild with "
            "`cli/search build`")

    version = meta.get("format_version")
    if version != FORMAT_VERSION:
        have = "pre-versioning" if version is None else f"version {version}"
        raise IndexCompatError(
            f"index at {index_dir} is {have}, this build reads version "
            f"{FORMAT_VERSION}; rebuild it with `cli/search build`")

    import zipfile

    try:
        z = np.load(npz_path)
        buffers = {k: z[k] for k in _NPZ_KEYS}
        npz_fp = bytes(z["fingerprint"]).decode() if "fingerprint" in z else None
    except FileNotFoundError:
        raise IndexCompatError(f"index buffers missing: {npz_path}")
    except (KeyError, ValueError, OSError, EOFError, zipfile.BadZipFile) as e:
        raise IndexCompatError(
            f"corrupt or truncated index buffers {npz_path} ({e}); rebuild "
            "with `cli/search build`")

    if npz_fp != meta.get("fingerprint"):
        raise IndexCompatError(
            f"index at {index_dir} mixes artifacts from different builds "
            "(embeddings.npz fingerprint does not match index_meta.json); "
            "rebuild with `cli/search build`")
    if (buffers["img_sets"].shape[0] != meta.get("n_images")
            or buffers["cap_sets"].shape[0] != meta.get("n_captions")):
        raise IndexCompatError(
            f"index at {index_dir}: buffer row counts disagree with "
            "metadata; rebuild with `cli/search build`")
    return SearchIndex(meta=meta, **buffers)
