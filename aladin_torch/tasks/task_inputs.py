"""Task input processors: VQA / GQA / NLVR2 example -> tensor conversion (a
copy of aladin_tpu/tasks/task_inputs.py over the port's data modules).

Equivalent capability to ref:oscar/utils/task_utils.py: typed example
records per task, label-space handling (VQA 3129-way soft answer scores, GQA
single answers, NLVR2 boolean pair choice), and conversion to the static
joint streams the classifiers consume (via data/dataset.py's
DisentangledTensorizer.tensorize_joint).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class VqaExample:
    qid: str
    question: str
    img_key: str
    # soft answer distribution over the answer vocabulary (VQA convention:
    # score in {0, 0.3, 0.6, 1} per annotator agreement)
    answer_scores: Dict[int, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GqaExample:
    qid: str
    question: str
    img_key: str
    answer: Optional[int] = None


@dataclasses.dataclass
class NlvrExample:
    uid: str
    statement: str
    img_key_left: str
    img_key_right: str
    label: Optional[int] = None  # 1 = statement true


def load_answer_vocab(path: str) -> Dict[str, int]:
    """answer -> index mapping (the VQA trainval label map)."""
    with open(path) as f:
        if path.endswith(".json"):
            d = json.load(f)
            if isinstance(d, list):
                return {a: i for i, a in enumerate(d)}
            return {k: int(v) for k, v in d.items()}
        # enumerate only NON-BLANK lines: raw line numbers would leave index
        # gaps that silently shrink the classifier's label space
        answers = [line.strip() for line in f if line.strip()]
        return {a: i for i, a in enumerate(answers)}


def vqa_soft_target(example: VqaExample, num_answers: int) -> np.ndarray:
    t = np.zeros(num_answers, np.float32)
    for idx, score in example.answer_scores.items():
        if 0 <= idx < num_answers:
            t[idx] = score
    return t


def convert_vqa_batch(examples: Sequence[VqaExample], tensorizer, get_image,
                      get_od_labels, num_answers: int):
    """-> (ids, mask, seg, feats, soft_targets) static numpy batch."""
    ids, mask, seg, feats, tgts = [], [], [], [], []
    for ex in examples:
        t = tensorizer.tensorize_joint(ex.question, get_od_labels(ex.img_key),
                                       get_image(ex.img_key))
        ids.append(t[0]); mask.append(t[1]); seg.append(t[2]); feats.append(t[3])
        tgts.append(vqa_soft_target(ex, num_answers))
    return (np.stack(ids), np.stack(mask), np.stack(seg),
            np.stack(feats).astype(np.float32), np.stack(tgts))


def convert_gqa_batch(examples: Sequence[GqaExample], tensorizer, get_image, get_od_labels):
    ids, mask, seg, feats, labels = [], [], [], [], []
    for ex in examples:
        t = tensorizer.tensorize_joint(ex.question, get_od_labels(ex.img_key),
                                       get_image(ex.img_key))
        ids.append(t[0]); mask.append(t[1]); seg.append(t[2]); feats.append(t[3])
        labels.append(ex.answer if ex.answer is not None else -1)
    return (np.stack(ids), np.stack(mask), np.stack(seg),
            np.stack(feats).astype(np.float32), np.asarray(labels, np.int64))


class ImageFeatureProvider:
    """Region features + OD-label text for the classification tasks.

    The image side of the retrieval dataset, standalone: features.tsv +
    imageid2idx.json + predictions.tsv in one directory
    (ref:oscar/run_vqa.py:171-210 reads the same artifacts per task)."""

    def __init__(self, img_feat_file: str, add_od_labels: bool = True):
        from aladin_torch.data.tsv import TSVFile, decode_region_features

        self._decode = decode_region_features
        self.tsv = TSVFile(img_feat_file)
        d = os.path.dirname(img_feat_file)
        with open(os.path.join(d, "imageid2idx.json")) as f:
            self.id2idx = json.load(f)
        self.labels: Dict[str, str] = {}
        self.objects: Dict[str, list] = {}
        if add_od_labels:
            pred = os.path.join(d, "predictions.tsv")
            if os.path.exists(pred):
                t = TSVFile(pred)
                for i in range(t.num_rows()):
                    row = t.seek(i)
                    res = json.loads(row[1])
                    objs = res["objects"] if isinstance(res, dict) else res
                    self.labels[str(row[0])] = " ".join(o["class"] for o in objs)
                    self.objects[str(row[0])] = objs
                t.close()

    def get_image(self, img_key) -> np.ndarray:
        row = self.tsv.seek(self.id2idx[str(img_key)])
        return self._decode(row[-1], int(row[1]))

    def get_od_labels(self, img_key) -> Optional[str]:
        return self.labels.get(str(img_key))

    def get_objects(self, img_key) -> list:
        """Structured detections [{class, rect?, conf?}, ...] - the CBS
        constraint source (ref:oscar/utils/cbs.py:526-645 consumes boxes,
        class names and detector confidences)."""
        return self.objects.get(str(img_key), [])


def load_vqa_examples(path: str, ans2label: Dict[str, int]) -> List[VqaExample]:
    """jsonl rows {qid, question, img_key, answers: {answer: score}}
    (capability of ref:oscar/utils/task_utils.py VQA processors: textual
    answers map through the trainval ans2label vocabulary)."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            scores = {
                ans2label[a]: float(s)
                for a, s in d.get("answers", {}).items()
                if a in ans2label
            }
            out.append(VqaExample(str(d["qid"]), d["question"], str(d["img_key"]), scores))
    return out


def load_gqa_examples(path: str, ans2label: Dict[str, int]) -> List[GqaExample]:
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            ans = d.get("answer")
            out.append(GqaExample(str(d["qid"]), d["question"], str(d["img_key"]),
                                  ans2label.get(ans) if ans is not None else None))
    return out


def load_nlvr_examples(path: str) -> List[NlvrExample]:
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            out.append(NlvrExample(str(d["uid"]), d["statement"],
                                   str(d["img_key_left"]), str(d["img_key_right"]),
                                   d.get("label")))
    return out


@dataclasses.dataclass
class VcrExample:
    """One VCR multiple-choice item (4 candidate texts, one correct)."""

    guid: str
    text_a: str  # question (q->a) or question+chosen answer (qa->r)
    choices: List[str]
    img_key: str
    q_id: int
    label: Optional[int] = None
    objects: Optional[list] = None


def load_vcr_examples(path: str, task: str = "vcr_q_a",
                      split: str = "train") -> List[VcrExample]:
    """The reference's three VCR processors over its ``vcr_{split}.json``
    layout (a JSON list of {q, choices, label, rational_choices,
    rational_label, img_id, annot_id, objects?};
    ref:oscar/utils/task_utils.py:273-414,567-575):

      * ``vcr_q_a``:  question -> answer choices;
      * ``vcr_qa_r``: question + gold answer -> rationale choices (needs
        ``label`` present - the reference indexes choices[label]
        unconditionally, ref:task_utils.py:355);
      * ``vcr_qar``:  the q->a examples, plus (train only) the qa->r
        examples appended (ref:task_utils.py:396-413).

    ``label``/``rational_label`` come back None for test splits
    (ref:task_utils.py:310).
    """
    if task not in ("vcr_q_a", "vcr_qa_r", "vcr_qar"):
        raise ValueError(task)
    with open(path) as f:
        lines = json.load(f)
    is_test = split.startswith("test")
    out: List[VcrExample] = []
    for i, line in enumerate(lines):
        q_id = int(str(line["annot_id"]).split("-")[-1])
        img_key = str(line["img_id"])
        objects = line.get("objects")

        def q_a(guid):
            return VcrExample(guid, line["q"], list(line["choices"]), img_key,
                              q_id, None if is_test else line["label"], objects)

        def qa_r(guid):
            return VcrExample(
                guid, line["q"] + " " + line["choices"][line["label"]],
                list(line["rational_choices"]), img_key, q_id,
                None if is_test else line["rational_label"], objects)

        if task == "vcr_q_a":
            out.append(q_a(f"{split}-{i}"))
        elif task == "vcr_qa_r":
            out.append(qa_r(f"{split}-{i}"))
        else:  # vcr_qar
            out.append(q_a(f"{split}-{i}-q-a"))
            if split == "train":
                out.append(qa_r(f"{split}-{i}-qa-r"))
    return out


def convert_vcr_batch(examples: Sequence[VcrExample], tensorizer, get_image):
    """-> (ids, mask, seg, feats) with a leading num_choices axis + labels,
    the ImageBertForMultipleChoice input layout (each choice tensorized as
    [CLS] text_a [SEP] choice [SEP] + regions, the reference's
    text_a/text_b pairing for VCR; ref:task_utils.py:424-547)."""
    out = {k: [] for k in ("ids", "mask", "seg", "feats")}
    labels = []
    for ex in examples:
        feats = get_image(ex.img_key)
        per_choice = [tensorizer.tensorize_joint(ex.text_a, choice, feats)
                      for choice in ex.choices]
        out["ids"].append(np.stack([c[0] for c in per_choice]))
        out["mask"].append(np.stack([c[1] for c in per_choice]))
        out["seg"].append(np.stack([c[2] for c in per_choice]))
        out["feats"].append(np.stack([c[3] for c in per_choice]))
        labels.append(ex.label if ex.label is not None else -1)
    return (np.stack(out["ids"]), np.stack(out["mask"]), np.stack(out["seg"]),
            np.stack(out["feats"]).astype(np.float32), np.asarray(labels, np.int64))


def make_synthetic_task_data(root: str, n_images: int = 8, feat_dim: int = 32,
                             n_examples: int = 32, seed: int = 0) -> None:
    """Features + answer vocab + vqa/gqa/nlvr jsonl splits, on disk.

    The questions are answerable from the image's OD tags so a small model
    can beat chance - the fixture carries real signal, not noise."""
    from aladin_torch.data.dataset import make_synthetic_dataset

    make_synthetic_dataset(root, n_images=n_images, feat_dim=feat_dim)
    rng = np.random.RandomState(seed)
    prov = ImageFeatureProvider(os.path.join(root, "features.tsv"))
    keys = sorted(prov.id2idx.keys())
    answers = ["yes", "no", "dog", "cat", "car", "tree", "person", "boat",
               "bird", "house"]
    with open(os.path.join(root, "answers.txt"), "w") as f:
        f.write("\n".join(answers))

    for split in ("train", "val", "test"):
        vqa, gqa, nlvr, vcr = [], [], [], []
        for i in range(n_examples):
            k = keys[int(rng.randint(len(keys)))]
            tags = (prov.get_od_labels(k) or "yes").split()
            ans = tags[0] if tags[0] in answers else "yes"
            second = answers[(answers.index(ans) + 1 + int(rng.randint(len(answers) - 1)))
                             % len(answers)]
            vqa.append({"qid": f"{split}{i}", "img_key": k,
                        "question": "what is in the picture",
                        "answers": {ans: 1.0, second: 0.3}})
            gqa.append({"qid": f"{split}{i}", "img_key": k,
                        "question": "what object appears here", "answer": ans})
            k2 = keys[int(rng.randint(len(keys)))]
            absent = [a for a in answers[2:] if a not in tags]
            if rng.rand() < 0.5 or not absent:
                noun, label = tags[0], 1
            else:  # a noun absent from the left image -> false statement
                noun, label = absent[int(rng.randint(len(absent)))], 0
            nlvr.append({"uid": f"{split}{i}",
                         "statement": f"the left image contains a {noun}",
                         "img_key_left": k, "img_key_right": k2, "label": label})
            # VCR: the correct answer choice names the image's tag
            wrong = [a for a in answers[2:] if a != ans][:3]
            pos = int(rng.randint(4))
            choices = [f"a {w}" for w in wrong]
            choices.insert(pos, f"a {ans}")
            r_pos = int(rng.randint(4))
            r_choices = [f"because there is no {w}" for w in wrong]
            r_choices.insert(r_pos, f"because a {ans} is visible")
            vcr.append({"annot_id": f"{split.upper()}-{i}", "img_id": k,
                        "q": "what is in the picture", "choices": choices,
                        "label": pos, "rational_choices": r_choices,
                        "rational_label": r_pos,
                        "objects": tags})
        for task, rows in (("vqa", vqa), ("gqa", gqa), ("nlvr", nlvr)):
            with open(os.path.join(root, f"{task}_{split}.jsonl"), "w") as f:
                f.write("\n".join(json.dumps(r) for r in rows))
        with open(os.path.join(root, f"vcr_{split}.json"), "w") as f:
            json.dump(vcr, f)


def convert_nlvr_batch(examples: Sequence[NlvrExample], tensorizer, get_image, get_od_labels):
    """-> (ids, mask, seg, feats) with a leading num_choices=2 axis + labels."""
    out = {k: [] for k in ("ids", "mask", "seg", "feats")}
    labels = []
    for ex in examples:
        per_choice = []
        for key in (ex.img_key_left, ex.img_key_right):
            per_choice.append(
                tensorizer.tensorize_joint(ex.statement, get_od_labels(key), get_image(key))
            )
        out["ids"].append(np.stack([c[0] for c in per_choice]))
        out["mask"].append(np.stack([c[1] for c in per_choice]))
        out["seg"].append(np.stack([c[2] for c in per_choice]))
        out["feats"].append(np.stack([c[3] for c in per_choice]))
        labels.append(ex.label if ex.label is not None else -1)
    return (np.stack(out["ids"]), np.stack(out["mask"]), np.stack(out["seg"]),
            np.stack(out["feats"]).astype(np.float32), np.asarray(labels, np.int64))
