"""Multi-corpus TSV pretraining dataset (the OSCAR+ corpus pipeline; a copy
of aladin_tpu/tasks/pretrain_data.py over the port's data/tsv.py).

Equivalent capability to ref:oscar/datasets/oscar_tsv.py:16-801
(OscarTSVDataset + convert_example_to_features): examples tensorize to
FIXED shapes on the host (one batch shape for the whole run), randomness
is derived per (epoch, index) from a seeded RandomState (reproducible +
thread-pool safe) instead of global `random`, and feature rows read
through the thread-safe TSV readers.

Data layout (the reference's multi-corpus structure, ref:oscar_tsv.py:33-52):

  root/
    corpus.tsv                  # rows: img_id \t label_id \t text_a
    <dataset>/features.tsv      # region features per dataset
    <dataset>/imageid2idx.json
    <dataset>/predictions_gt.tsv  # OD tag labels (text_b source)

``img_id`` is ``<dataset>_<imageid>`` (ref:oscar_tsv.py:100-116); rows whose
dataset is not in ``datasets`` are skipped, which is how one corpus file
serves many dataset subsets.

Example synthesis (ref:oscar_tsv.py:209-283 __getitem__/random_sent):
  * 50%: matched (text_a, text_b=tags) pair -> contrastive label 0;
  * with prob (0.5 - texta_false_prob): text_b swapped from a random other
    image -> label 1;
  * with prob texta_false_prob: text_a swapped -> label num_contrast-1;
  * MLM masking via random_word_mask (80/10/10), with
    ``mask_loss_for_unmatched=False`` suppressing text_b labels on
    mismatched pairs (ref:oscar_tsv.py:674-681);
  * streams: [CLS] a [SEP] b [SEP] with 0/1 segments, attention mask
    covering text + real region rows, lm labels -1 padded over image slots
    (ref:oscar_tsv.py:684-760).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from aladin_torch.data.tsv import TSVFile, decode_region_features
from aladin_torch.tasks.pretraining import random_word_mask


class PretrainCorpus:
    """Random-access multi-corpus pretraining examples with fixed shapes."""

    def __init__(
        self,
        root: str,
        tokenizer,
        datasets: Sequence[str],
        seq_len: int = 35,
        max_img_seq_length: int = 50,
        img_feature_dim: int = 2054,
        use_b: bool = True,
        texta_false_prob: float = 0.0,
        num_contrast_classes: int = 2,
        mask_loss_for_unmatched: bool = True,
        seed: int = 0,
        corpus_file: str = "corpus.tsv",
    ):
        self.root = root
        self.tokenizer = tokenizer
        self.datasets = list(datasets)
        self.seq_len = seq_len
        self.max_img_seq_length = max_img_seq_length
        self.img_feature_dim = img_feature_dim
        self.use_b = use_b
        self.texta_false_prob = texta_false_prob
        self.num_contrast_classes = num_contrast_classes
        self.mask_loss_for_unmatched = mask_loss_for_unmatched
        self.seed = seed

        self.features: Dict[str, TSVFile] = {}
        self.id2idx: Dict[str, Dict[str, int]] = {}
        self.tags: Dict[str, Dict[str, str]] = {}
        for ds in self.datasets:
            ddir = os.path.join(root, ds)
            self.features[ds] = TSVFile(os.path.join(ddir, "features.tsv"))
            with open(os.path.join(ddir, "imageid2idx.json")) as f:
                self.id2idx[ds] = json.load(f)
            tag_file = os.path.join(ddir, "predictions_gt.tsv")
            tags: Dict[str, str] = {}
            if os.path.exists(tag_file):
                t = TSVFile(tag_file)
                for i in range(len(t)):
                    row = t.seek(i)
                    # rows: image_id \t json({"objects": [{"class": ...}]}) or plain tag text
                    try:
                        objs = json.loads(row[1])
                        if not isinstance(objs, dict):  # JSON scalar/array
                            raise TypeError(type(objs).__name__)
                        tags[str(row[0])] = " ".join(
                            o["class"] for o in objs.get("objects", [])
                        )
                    except (json.JSONDecodeError, TypeError):
                        tags[str(row[0])] = row[1]
                t.close()
            self.tags[ds] = tags

        # corpus rows filtered to the selected datasets (ref:oscar_tsv.py:100-116)
        self.rows: List[List[str]] = []
        corpus = TSVFile(os.path.join(root, corpus_file))
        for i in range(len(corpus)):
            row = corpus.seek(i)
            ds = row[0].split("_")[0]
            if ds in self.datasets:
                self.rows.append(row)
        corpus.close()
        assert self.rows, f"no corpus rows for datasets {self.datasets}"

    def __len__(self) -> int:
        return len(self.rows)

    # -- raw pieces ------------------------------------------------------
    def _split_id(self, img_id: str):
        ds, _, iid = img_id.partition("_")
        return ds, iid

    def _text_b(self, img_id: str) -> str:
        ds, iid = self._split_id(img_id)
        return self.tags[ds].get(iid, "")

    def _img_feature(self, img_id: str) -> np.ndarray:
        ds, iid = self._split_id(img_id)
        idx = self.id2idx[ds][iid]
        row = self.features[ds].seek(idx)
        return decode_region_features(row[-1], int(row[1]))

    # -- example synthesis -----------------------------------------------
    def example(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 7_368_787 + index) % (2**31 - 1)
        )
        row = self.rows[index]
        img_id, text_a = row[0], row[2]
        text_b = self._text_b(img_id) if self.use_b else ""

        # random_sent (ref:oscar_tsv.py:256-283)
        dice = rng.rand()
        is_img_match = 0
        if dice > 0.5:
            label = 0
        elif dice > self.texta_false_prob and text_b != "":
            # text_b is only nonempty when use_b, so the swap is always a
            # tag-text swap (ref:oscar_tsv.py:262-270)
            other = self.rows[rng.randint(len(self.rows))]
            text_b = self._text_b(other[0])
            label = 1
            is_img_match = int(other[0] != img_id)
        else:
            other = self.rows[rng.randint(len(self.rows))]
            text_a = other[2]
            label = self.num_contrast_classes - 1
            is_img_match = int(other[0] != img_id)

        # is_next_type (ref:oscar_tsv.py:685-687) gates ONLY the
        # b-segment mask-loss decision below; the seq-relation label fed to
        # the loss is `label` itself (the reference's example.is_next,
        # ref:oscar_tsv.py:782,251 — the remapped value never reaches the
        # head, which has exactly num_contrast_classes logits)
        is_next_type = label * is_img_match if label else 0
        if self.num_contrast_classes == 2 and self.texta_false_prob == 0.5 and is_next_type == 1:
            is_next_type = 2

        tok = self.tokenizer
        # pre-cap at seq_len (C++ fast path when available): the pop-from-
        # the-longer-side loop below visits every length on the way down, so
        # any cap >= the -3 budget leaves its fixed point unchanged
        if hasattr(tok, "encode_trunc"):
            a_ids = tok.encode_trunc(text_a, self.seq_len)
            b_ids = tok.encode_trunc(text_b, self.seq_len) if text_b else []
        else:
            a_ids = tok.convert_tokens_to_ids(tok.tokenize(text_a))
            b_ids = (tok.convert_tokens_to_ids(tok.tokenize(text_b))
                     if text_b else [])
        if b_ids:
            # _truncate_seq_pair: trim the longer side until it fits -3
            while len(a_ids) + len(b_ids) > self.seq_len - 3:
                (a_ids if len(a_ids) > len(b_ids) else b_ids).pop()
        else:
            a_ids = a_ids[: self.seq_len - 2]

        vocab = tok.vocab
        mask_id = vocab["[MASK]"]
        special = (vocab["[PAD]"],)
        a_arr, a_lab = random_word_mask(np.asarray(a_ids, np.int64), len(vocab), rng, mask_id, special)
        if b_ids:
            if not self.mask_loss_for_unmatched and is_next_type == 1:
                b_arr, b_lab = np.asarray(b_ids, np.int64), np.full(len(b_ids), -1, np.int64)
            else:
                b_arr, b_lab = random_word_mask(np.asarray(b_ids, np.int64), len(vocab), rng, mask_id, special)

        cls_, sep = vocab["[CLS]"], vocab["[SEP]"]
        ids = [cls_, *a_arr.tolist(), sep]
        seg = [0] * len(ids)
        lm = [-1, *a_lab.tolist(), -1]
        if b_ids:
            ids += [*b_arr.tolist(), sep]
            seg += [1] * (len(b_arr) + 1)
            lm += [*b_lab.tolist(), -1]
        n_text = len(ids)
        pad = self.seq_len - n_text
        ids += [0] * pad
        seg += [0] * pad
        lm += [-1] * pad

        feats = self._img_feature(img_id)[: self.max_img_seq_length]
        n_img = feats.shape[0]
        feats = np.pad(
            feats.astype(np.float32),
            ((0, self.max_img_seq_length - n_img), (0, 0)),
        )
        mask = [1] * n_text + [0] * pad + [1] * n_img + [0] * (self.max_img_seq_length - n_img)
        lm += [-1] * self.max_img_seq_length

        return {
            "input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(mask, np.int32),
            "token_type_ids": np.asarray(seg, np.int32),
            "img_feats": feats,
            "lm_labels": np.asarray(lm, np.int32),
            "is_next": np.int32(label),
        }

    def collate(self, indices: Sequence[int], epoch: int = 0) -> Dict[str, np.ndarray]:
        exs = [self.example(i, epoch) for i in indices]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}


def make_synthetic_pretrain_corpus(
    root: str,
    datasets: Sequence[str] = ("coco", "flickr30k"),
    n_images_per_dataset: int = 6,
    feat_dim: int = 32,
    seed: int = 0,
) -> None:
    """On-disk fixture with the multi-corpus layout (tests + --synthetic)."""
    from aladin_torch.data.tsv import write_tsv

    rng = np.random.RandomState(seed)
    nouns = ["dog", "cat", "car", "tree", "person", "boat", "bird", "house"]
    corpus_rows = []
    os.makedirs(root, exist_ok=True)
    for ds in datasets:
        ddir = os.path.join(root, ds)
        os.makedirs(ddir, exist_ok=True)
        rows, tags, id2idx = [], [], {}
        for i in range(n_images_per_dataset):
            iid = str(1000 + i)
            nb = int(rng.randint(3, 8))
            feats = rng.randn(nb, feat_dim).astype(np.float32)
            import base64

            rows.append([iid, nb, base64.b64encode(feats.tobytes()).decode("ascii")])
            id2idx[iid] = i
            objs = [{"class": nouns[int(rng.randint(len(nouns)))]} for _ in range(3)]
            tags.append([iid, json.dumps({"objects": objs})])
            cap = f"a photo of a {nouns[i % len(nouns)]} in {ds}"
            corpus_rows.append([f"{ds}_{iid}", f"{ds}_{iid}", cap])
        write_tsv(os.path.join(ddir, "features.tsv"), rows)
        write_tsv(os.path.join(ddir, "predictions_gt.tsv"), tags)
        with open(os.path.join(ddir, "imageid2idx.json"), "w") as f:
            json.dump(id2idx, f)
    rng.shuffle(corpus_rows)
    write_tsv(os.path.join(root, "corpus.tsv"), corpus_rows)
