"""nocaps evaluation — the offline half of the reference's EvalAI flow (a
copy of aladin_tpu/eval/nocaps.py).

Equivalent capability to ref:oscar/utils/caption_evaluate.py:20-57
(``evaluate_on_nocaps``) and the ``NocapsEvaluator`` result restructuring
(ref:oscar/utils/caption_evaluate.py:200-290, itself from
nocaps-org/updown-baseline). The reference's flow is: prediction TSV ->
COCO-format predictions via the split's image-info id map -> HTTP
submission to EvalAI -> poll for the per-domain metric list -> flip it
into ``{metric: {domain: value}}``.

Everything except the HTTP submission (environment-hostile: zero egress,
and EvalAI credentials are a user artifact) is implemented here:

1. :func:`convert_nocaps_predictions` — prediction TSV -> EvalAI/COCO
   prediction list via ``nocaps_{split}_image_info.json`` (same row
   contract as the reference: ``open_images_id \\t json list of
   {"caption": ...}``; first caption wins, sequential ``id`` counter).
2. :func:`write_evalai_submission` — persist that list as the JSON file
   the EvalAI CLI / web upload takes; submitting it is the user's action.
3. :func:`flip_domain_metrics` — the NocapsEvaluator restructuring of
   EvalAI's response (a list of one-domain dicts) into
   ``{metric: {domain: value}}`` for tensorboard-friendly logging.
4. :func:`evaluate_nocaps_offline` — what the reference cannot do at all:
   when ground-truth annotations are available locally (the public nocaps
   val annotation JSON carries a per-image ``domain`` field), compute the
   SAME nested metric table locally with the native scorers
   (eval/caption_metrics.py), grouped in-domain / near-domain /
   out-domain / entire — no network, no jars required (SPICE optional).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

DOMAINS = ("in-domain", "near-domain", "out-domain", "entire")

# EvalAI reports BLEU as B1..B4 and ROUGE-L with a dash; the native
# scorers use the coco-caption names. One table, used in both directions.
_METRIC_NAMES = {
    "Bleu_1": "B1", "Bleu_2": "B2", "Bleu_3": "B3", "Bleu_4": "B4",
    "METEOR": "METEOR", "ROUGE_L": "ROUGE-L", "CIDEr": "CIDEr",
    "SPICE": "SPICE",
}


def load_image_info(image_info_file: str):
    """``(open_images_id -> id, id -> domain)`` from a nocaps image-info or
    annotation JSON. ``domain`` entries exist only in files that carry them
    (the public val annotations do; bare image-info files may not)."""
    with open(image_info_file) as f:
        info = json.load(f)
    open_id2id: Dict[str, int] = {}
    id2domain: Dict[int, str] = {}
    for it in info["images"]:
        open_id2id[it["open_images_id"]] = it["id"]
        if "domain" in it:
            id2domain[it["id"]] = it["domain"]
    return open_id2id, id2domain


def convert_nocaps_predictions(
    predict_file: str, image_info_file: str
) -> List[Dict]:
    """Prediction TSV -> EvalAI/COCO-format prediction list.

    Row contract (ref:oscar/utils/caption_evaluate.py:38-46): column 0 is
    the Open Images id, column 1 a JSON list of caption dicts; the first
    caption is submitted. ``id`` is a sequential caption counter. An
    unknown Open Images id raises KeyError, as in the reference.
    """
    open_id2id, _ = load_image_info(image_info_file)
    predictions: List[Dict] = []
    cap_id = 0
    with open(predict_file) as fp:
        for line in fp:
            if not line.strip():
                continue
            p = line.rstrip("\n").split("\t")
            predictions.append(
                {
                    "image_id": open_id2id[p[0]],
                    "caption": json.loads(p[1])[0]["caption"],
                    "id": cap_id,
                }
            )
            cap_id += 1
    return predictions


def write_evalai_submission(predictions: Sequence[Dict], out_file: str) -> str:
    """Write the prediction list as the JSON file EvalAI accepts
    (ref:oscar/utils/caption_evaluate.py:266-269 writes the same payload to
    a tempfile before shelling out to the ``evalai`` CLI)."""
    with open(out_file, "w") as f:
        json.dump(list(predictions), f)
    return out_file


def flip_domain_metrics(evalai_response) -> Dict[str, Dict[str, float]]:
    """EvalAI's per-domain metric list -> ``{metric: {domain: value}}``.

    The response is a list of single-key dicts, one per domain
    (ref:oscar/utils/caption_evaluate.py:318-337). The reference assumes a
    fixed order (``metrics[0]["in-domain"]`` ...); here the domains are
    matched by key so a reordered response still parses.
    """
    by_domain: Dict[str, Dict[str, float]] = {}
    for entry in evalai_response:
        for domain, vals in entry.items():
            if domain in DOMAINS:
                by_domain[domain] = vals
    missing = [d for d in DOMAINS if d not in by_domain]
    if missing:
        raise ValueError(f"EvalAI response missing domains {missing}")
    flipped: Dict[str, Dict[str, float]] = defaultdict(dict)
    for domain, vals in by_domain.items():
        for metric, value in vals.items():
            flipped[metric][domain] = value
    return dict(flipped)


def evaluate_nocaps_offline(
    predict_file: str,
    annotations_file: str,
    image_info_file: Optional[str] = None,
    include_spice: bool = False,
) -> Dict[str, Dict[str, float]]:
    """Local per-domain nocaps evaluation against ground-truth annotations.

    ``annotations_file``: COCO-format JSON whose ``images`` entries carry
    ``id``, ``open_images_id`` and ``domain`` (the public nocaps val
    annotation layout) plus ``annotations`` with ``image_id``/``caption``.
    ``image_info_file`` defaults to the annotations file (it contains the
    same id map). Returns the NocapsEvaluator-shaped nested dict
    ``{metric: {in-domain, near-domain, out-domain, entire}}`` with the
    EvalAI metric names (B1..B4, METEOR, ROUGE-L, CIDEr, optional SPICE),
    computed with the native scorers instead of a remote submission.

    Images without a prediction are dropped (with the same semantics as
    eval/caption_metrics.evaluate_caption_file: GT restricted to predicted
    ids); a metric group with no images reports an empty slot rather than
    a crash.
    """
    from aladin_torch.eval.caption_metrics import evaluate_captions

    predictions = convert_nocaps_predictions(
        predict_file, image_info_file or annotations_file
    )
    _, id2domain = load_image_info(annotations_file)
    with open(annotations_file) as f:
        ann = json.load(f)
    gts: Dict[int, List[str]] = defaultdict(list)
    for a in ann["annotations"]:
        gts[a["image_id"]].append(a["caption"])

    preds = {p["image_id"]: [p["caption"]] for p in predictions}
    ids = [i for i in preds if i in gts]

    out: Dict[str, Dict[str, float]] = defaultdict(dict)
    for domain in DOMAINS:
        subset = ids if domain == "entire" else [
            i for i in ids if id2domain.get(i) == domain
        ]
        if not subset:
            continue
        scores = evaluate_captions(
            {i: preds[i] for i in subset},
            {i: gts[i] for i in subset},
            include_spice=include_spice,
        )
        for name, value in scores.items():
            if name in _METRIC_NAMES:
                out[_METRIC_NAMES[name]][domain] = value
    return dict(out)


def main(argv=None):
    """``python -m aladin_torch.eval.nocaps pred.tsv --image_info info.json
    [--annotations ann.json] [--out submission.json]`` — converts a
    prediction TSV to an EvalAI submission file and, when local annotations
    are given, prints the offline per-domain metric table."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("predict_file")
    ap.add_argument("--image_info", required=False)
    ap.add_argument("--annotations", required=False)
    ap.add_argument("--out", default=None)
    ap.add_argument("--include_spice", action="store_true")
    args = ap.parse_args(argv)
    if not (args.image_info or args.annotations):
        ap.error("need --image_info and/or --annotations")

    preds = convert_nocaps_predictions(
        args.predict_file, args.image_info or args.annotations
    )
    out = args.out or args.predict_file.rsplit(".", 1)[0] + ".evalai.json"
    write_evalai_submission(preds, out)
    print(f"wrote {len(preds)} predictions -> {out}")
    if args.annotations:
        metrics = evaluate_nocaps_offline(
            args.predict_file, args.annotations, args.image_info,
            include_spice=args.include_spice,
        )
        print(json.dumps(metrics, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
