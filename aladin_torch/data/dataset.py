"""COCO image-text retrieval dataset: TSV region features + caption stores.

A copy of aladin_tpu/data/dataset.py that decodes features with the
pure-Python TSV reader only (the native C++ reader is not ported yet).

Behavioral contract (ref:alad/dataset.py RetrievalDataset/MyCollate):

  * captions come from ``{split}_captions.pt`` - a dict {img_key(int):
    [5 caption strings]} (possibly json-encoded lists) (:37-42);
  * ``imageid2idx.json`` maps str(img_id) -> row in the features TSV (:45-46);
  * OD labels parse from ``predictions.tsv`` into space-joined class lists
    (:48-70); label TSV is closed before workers fork (:69-70);
  * eval subsets (COCO 1k/5k) select img_keys from ``eval_img_keys_file``
    (:76-84);
  * dataset length = n_images x captions_per_image; index (i) -> image
    i // ncpi, caption i % ncpi (:104-119,326-327);
  * region features: TSV row -> base64 -> (num_boxes, 2054) f32 (:317-324);
  * the DISENTANGLED tensorizer (:203-280) builds two independent streams:
      - text:  [CLS] + caption tokens (<= max_seq-2) + [SEP], pad to
        max_seq; segment ids 0; mask = 1 on real tokens;
      - image: label tokens (<= max_seq-2) + [SEP] with a leading slot that
        the reference fills with the INTEGER 0 (the ``cls_token_segment_id``
        variable, a bug) which pytorch_transformers maps to [UNK]; segment
        ids [0] + 1s; regions clipped/zero-padded to max_img_seq; mask covers
        label tokens then regions ('CLR' 1-D layout).

Faithfulness knob: ``faithful_image_unk_slot`` (default True) reproduces the
[UNK] leading token the released checkpoint was trained with; False uses
[CLS] (the evident intent).

Static shapes: every sample is padded to (max_seq, max_img_seq) at
tensorize time, lengths ride as int32, and collation is a numpy stack. The
DataLoader worker pool is replaced by the thread pool of data/pipeline.py.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from aladin_torch.config import DataArgs
from aladin_torch.data.tsv import TSVFile, decode_region_features


@dataclass
class Example:
    """One tensorized disentangled sample (static shapes, numpy)."""

    txt_ids: np.ndarray  # (L,) int32
    txt_mask: np.ndarray  # (L,) int32
    txt_type: np.ndarray  # (L,) int32
    cap_len: int
    img_ids: np.ndarray  # (L,) int32
    img_mask: np.ndarray  # (L + R,) int32
    img_type: np.ndarray  # (L,) int32
    img_feats: np.ndarray  # (R, feat_dim) float32
    img_len: int


class DisentangledTensorizer:
    """Static-shape port of tensorize_example_disentangled semantics."""

    def __init__(self, tokenizer, max_seq_len: int, max_img_seq_len: int,
                 img_feature_dim: int = 2054, faithful_image_unk_slot: bool = True):
        self.tok = tokenizer
        self.max_seq_len = max_seq_len
        self.max_img_seq_len = max_img_seq_len
        self.img_feature_dim = img_feature_dim
        self.faithful_image_unk_slot = faithful_image_unk_slot
        ids = tokenizer.convert_tokens_to_ids(
            [tokenizer.pad_token, tokenizer.cls_token, tokenizer.sep_token,
             tokenizer.unk_token])
        self.pad_id, self.cls_id, self.sep_id, self.unk_id = ids

    def _encode_trunc(self, text: str, max_tokens: int):
        """Body WordPiece ids, truncated (data/tokenizer.py encode_trunc_any)."""
        from aladin_torch.data.tokenizer import encode_trunc_any

        return encode_trunc_any(self.tok, text, max_tokens)

    def text_stream(self, caption: str):
        body = self._encode_trunc(caption, self.max_seq_len - 2)
        seq_len = len(body) + 2
        ids = ([self.cls_id] + body + [self.sep_id]
               + [self.pad_id] * (self.max_seq_len - seq_len))
        seg = [0] * self.max_seq_len
        mask = [1] * seq_len + [0] * (self.max_seq_len - seq_len)
        return (
            np.asarray(ids, np.int32),
            np.asarray(mask, np.int32),
            np.asarray(seg, np.int32),
            seq_len,
        )

    def image_stream(self, od_labels: Optional[str], feats: np.ndarray):
        body = self._encode_trunc(od_labels or "", self.max_seq_len - 2)
        # faithful mode: the reference puts the int 0 in the CLS slot, which
        # its id-conversion maps to [UNK] (ref:alad/dataset.py:226 quirk)
        first = self.unk_id if self.faithful_image_unk_slot else self.cls_id
        seq_len = len(body) + 2
        ids = ([first] + body + [self.sep_id]
               + [self.pad_id] * (self.max_seq_len - seq_len))
        seg = [0] + [1] * (seq_len - 1) + [0] * (self.max_seq_len - seq_len)

        img_len = min(feats.shape[0], self.max_img_seq_len)
        out_feats = np.zeros((self.max_img_seq_len, self.img_feature_dim), np.float32)
        out_feats[:img_len] = feats[:img_len, : self.img_feature_dim]
        mask = (
            [1] * seq_len
            + [0] * (self.max_seq_len - seq_len)
            + [1] * img_len
            + [0] * (self.max_img_seq_len - img_len)
        )
        return (
            np.asarray(ids, np.int32),
            np.asarray(mask, np.int32),
            np.asarray(seg, np.int32),
            out_feats,
            img_len,
        )

    def tensorize(self, caption: str, od_labels: Optional[str], feats: np.ndarray) -> Example:
        t_ids, t_mask, t_seg, cap_len = self.text_stream(caption)
        i_ids, i_mask, i_seg, i_feats, img_len = self.image_stream(od_labels, feats)
        return Example(t_ids, t_mask, t_seg, cap_len, i_ids, i_mask, i_seg, i_feats, img_len)


def _load_captions_raw(path: str):
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
    else:
        import torch

        raw = torch.load(path, map_location="cpu", weights_only=False)
    return {
        k: (v if isinstance(v, list) else json.loads(v)) for k, v in raw.items()
    }


def _load_captions(path: str) -> Dict[int, List[str]]:
    return {int(k): v for k, v in _load_captions_raw(path).items()}


class RetrievalDataset:
    """Image/text retrieval dataset over pre-extracted VinVL features."""

    def __init__(self, tokenizer, args: DataArgs, split: str = "train", is_train: bool = True):
        self.args = args
        self.split = split
        self.is_train = is_train
        self.img_tsv = TSVFile(args.img_feat_file)
        cap_file_pt = os.path.join(args.data_dir, f"{split}_captions.pt")
        cap_file_json = os.path.join(args.data_dir, f"{split}_captions.json")
        self.captions = _load_captions(
            cap_file_pt if os.path.exists(cap_file_pt) else cap_file_json
        )
        self.img_keys: List[int] = list(self.captions.keys())

        with open(os.path.join(os.path.dirname(args.img_feat_file), "imageid2idx.json")) as f:
            self.image_id2idx = json.load(f)

        self.labels: Dict[int, str] = {}
        if args.add_od_labels:
            label_file = os.path.join(os.path.dirname(args.img_feat_file), "predictions.tsv")
            label_tsv = TSVFile(label_file)
            keys = set(self.img_keys)
            for row_no in range(label_tsv.num_rows()):
                row = label_tsv.seek(row_no)
                image_id = int(row[0])
                if image_id in keys:
                    results = json.loads(row[1])
                    objects = results["objects"] if isinstance(results, dict) else results
                    self.labels[image_id] = " ".join(o["class"] for o in objects)
            label_tsv.close()  # close before workers fork (ref:dataset.py:69-70)

        self.has_caption_indexs = False
        self.caption_indexs: Dict[int, list] = {}
        if not is_train:
            self.num_captions_per_img = args.num_captions_per_img_val
            if args.eval_img_keys_file:
                with open(os.path.join(args.data_dir, args.eval_img_keys_file)) as f:
                    self.img_keys = [int(k.strip()) for k in f if k.strip()]
                self.captions = {k: self.captions[k] for k in self.img_keys}
                if args.add_od_labels:
                    self.labels = {k: self.labels[k] for k in self.img_keys}
            if args.eval_caption_index_file:
                # hard-negative (img_key, cap_idx) lists for re-rank minival
                # monitoring (ref:alad/dataset.py:86-97)
                self.has_caption_indexs = True
                idx_path = os.path.join(args.data_dir, args.eval_caption_index_file)
                raw = _load_captions_raw(idx_path)
                self.caption_indexs = {int(k): v for k, v in raw.items()}
        else:
            self.num_captions_per_img = args.num_captions_per_img_train

        self.tensorizer = DisentangledTensorizer(
            tokenizer, args.max_seq_length, args.max_img_seq_length, args.img_feature_dim
        )

    def __len__(self) -> int:
        return len(self.img_keys) * self.num_captions_per_img

    def get_image(self, image_id: int) -> np.ndarray:
        idx = self.image_id2idx[str(image_id)]
        row = self.img_tsv.seek(idx)
        return decode_region_features(row[-1], int(row[1]))

    def get_od_labels(self, image_id: int) -> Optional[str]:
        return self.labels.get(image_id) if self.args.add_od_labels else None

    def get_image_caption_index(self, index: int):
        """index -> (img_idx, [caption img_key, cap_idx]); honors the
        hard-negative rerank indexes when loaded (ref:alad/dataset.py:104-119
        + the reference's caption_indexs semantics)."""
        img_idx = index // self.num_captions_per_img
        cap_idx = index % self.num_captions_per_img
        if self.has_caption_indexs:
            key1, cap_idx1 = self.caption_indexs[self.img_keys[img_idx]][cap_idx]
            return img_idx, [int(key1), int(cap_idx1)]
        return img_idx, [self.img_keys[img_idx], cap_idx]

    def example(self, index: int) -> Example:
        img_idx, (cap_key, cap_idx) = self.get_image_caption_index(index)
        key = self.img_keys[img_idx]
        return self.tensorizer.tensorize(
            self.captions[cap_key][cap_idx], self.get_od_labels(key), self.get_image(key)
        )

    def length_hint(self, index: int) -> int:
        """Cheap caption-length proxy (word count, no tokenization) for
        length-sorted eval batching (BatchLoader sort_by_length)."""
        _, (cap_key, cap_idx) = self.get_image_caption_index(index)
        return len(self.captions[cap_key][cap_idx].split())

    def collate(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Static-shape batch (numpy) - MyCollate equivalent
        (ref:dataset.py:332-361)."""
        ex = [self.example(i) for i in indices]
        return {
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


def make_synthetic_dataset(root: str, n_images: int = 8, feat_dim: int = 2054,
                           seed: int = 0, max_boxes: int = 20,
                           distinguishable: bool = False) -> None:
    """Write a tiny on-disk fixture with the reference's file layout
    (features.tsv + lineidx, imageid2idx.json, {split}_captions.json,
    predictions.tsv) for tests and the --synthetic CLI path.

    ``distinguishable=True`` makes the corpus MEMORIZABLE: every caption
    uniquely identifies its image (the image index is spelled digit-by-digit
    so the synthetic fallback vocab covers it), so a correctly-wired model
    can drive retrieval rsum to its 600 ceiling by memorization. This is the
    corpus behind the convergence gate (tests/test_convergence.py) — the
    default corpus reuses caption sets across images (any two keys congruent
    mod len(nouns) share all 5 captions), capping achievable recall."""
    import base64

    from aladin_torch.data.tsv import write_tsv

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    keys = [100 + i for i in range(n_images)]
    rows, preds = [], []
    id2idx = {}
    nouns = ["dog", "cat", "car", "tree", "person", "boat", "bird", "house"]
    for i, k in enumerate(keys):
        nb = int(rng.randint(3, max_boxes + 1))
        feats = rng.randn(nb, feat_dim).astype(np.float32)
        rows.append([k, nb, base64.b64encode(feats.tobytes()).decode("ascii")])
        id2idx[str(k)] = i
        objs = [{"class": nouns[int(rng.randint(len(nouns)))],
                 "rect": [0, 0, 10, 10]} for _ in range(nb)]
        preds.append([k, json.dumps({"objects": objs, "image_h": 600, "image_w": 800})])
    write_tsv(os.path.join(root, "features.tsv"), rows)
    write_tsv(os.path.join(root, "predictions.tsv"), preds)
    with open(os.path.join(root, "imageid2idx.json"), "w") as f:
        json.dump(id2idx, f)
    for split in ("train", "minival", "test"):
        if distinguishable:
            caps = {
                k: [f"a photo of the {nouns[(k - 100) % len(nouns)]} number "
                    f"{' '.join(str(k - 100))} {j}" for j in range(5)]
                for k in keys
            }
        else:
            caps = {
                k: [f"a photo of a {nouns[(k + j) % len(nouns)]} number {j}" for j in range(5)]
                for k in keys
            }
        with open(os.path.join(root, f"{split}_captions.json"), "w") as f:
            json.dump(caps, f)
    with open(os.path.join(root, "test_img_keys.tsv"), "w") as f:
        f.write("\n".join(str(k) for k in keys))
    # the 1k-protocol subset file (real COCO ships test_img_keys_1k.tsv
    # alongside the 5k file, ref:alad/README.md:88-94): first half here
    with open(os.path.join(root, "test_img_keys_1k.tsv"), "w") as f:
        f.write("\n".join(str(k) for k in keys[: max(len(keys) // 2, 1)]))
