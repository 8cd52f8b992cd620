"""The caption and relevance metrics of aladin_torch (eval/{cider, meteor,
spice, caption_metrics, nocaps, relevance}.py) against aladin_tpu's on the
same captions. The port's modules are copies of host code, so every number
must be equal, not close.

The PTB tokenizer and SPICE speak to Java jars over temporary files; as in
tests/test_spice_protocol.py, a Python stub interpreter that speaks the same
protocols stands in for the JVM (``JAVA`` patched), so the real temp-file
formats, argv contracts and output parsing run here without a jar.
"""

import json
import sys

import numpy as np
import pytest

import aladin_tpu.eval.caption_metrics as jax_cm
import aladin_tpu.eval.cider as jax_cider
import aladin_tpu.eval.meteor as jax_meteor
import aladin_tpu.eval.nocaps as jax_nocaps
import aladin_tpu.eval.relevance as jax_relevance
import aladin_tpu.eval.spice as jax_spice
import aladin_torch.eval.caption_metrics as cm
import aladin_torch.eval.cider as cider
import aladin_torch.eval.meteor as meteor
import aladin_torch.eval.nocaps as nocaps
import aladin_torch.eval.relevance as relevance
import aladin_torch.eval.spice as spice
from tests.test_nocaps import DOMAIN, GT, OPEN_ID
from tests.test_spice_protocol import STUB

GTS = {0: ["a dog runs on the grass", "the brown dog is running"],
       1: ["a red car parked on the street", "car on a road"],
       2: ["two birds on a wire", "birds perched on a power line"],
       3: ["an accordion on a wooden table", "an accordion sits on a table"]}
PREDS = {
    "verbatim": {k: [v[0]] for k, v in GTS.items()},
    "paraphrase": {0: ["a dog running on grass"], 1: ["a parked red car"],
                   2: ["birds sitting on wires"], 3: ["a shiny accordion on the table"]},
    "wrong": {0: ["purple elephant"], 1: ["nothing here"], 2: ["a a a a"], 3: ["tables"]},
}
QUERIES = [["a dog on the grass"], ["A cat sleeps", "the cat on a sofa"],
           ["two people ride bikes"]]
IMAGES = [["a dog runs on grass", "the brown dog"], ["a cat on a sofa", "cat sleeping"],
          ["people riding bikes on a road", "two cyclists"], ["an empty room"]]


@pytest.mark.parametrize("case", sorted(PREDS))
def test_bleu_cider_meteor_rouge_equal_jax(case):
    preds = PREDS[case]
    ids = sorted(GTS)
    hyps, refs = [preds[i][0] for i in ids], [GTS[i] for i in ids]
    assert cm.bleu_score(hyps, refs) == jax_cm.bleu_score(hyps, refs)
    got, want = cider.CiderD().compute_score(GTS, preds), jax_cider.CiderD().compute_score(
        GTS, preds)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    got, want = meteor.Meteor().compute_score(GTS, preds), jax_meteor.Meteor().compute_score(
        GTS, preds)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    for i in ids:
        assert meteor.meteor_score(GTS[i], preds[i][0]) == jax_meteor.meteor_score(
            GTS[i], preds[i][0])
    assert cm.evaluate_captions(preds, GTS) == jax_cm.evaluate_captions(preds, GTS)


def test_evaluate_captions_ranks_and_skips_spice_without_jar(monkeypatch, tmp_path):
    good, bad = (cm.evaluate_captions(PREDS[k], GTS) for k in ("verbatim", "wrong"))
    assert good["ROUGE_L"] == 1.0 and good["CIDEr"] > bad["CIDEr"]
    assert good["Bleu_4"] > bad["Bleu_4"] and good["METEOR"] > bad["METEOR"]
    monkeypatch.setattr(spice, "SPICE_JAR", str(tmp_path / "absent.jar"))
    monkeypatch.setattr(jax_spice, "SPICE_JAR", str(tmp_path / "absent.jar"))
    got = cm.evaluate_captions(PREDS["verbatim"], GTS, include_spice=True)
    assert "ALADIN_SPICE_JAR" in got["SPICE_skipped"]
    assert got == jax_cm.evaluate_captions(PREDS["verbatim"], GTS, include_spice=True)


def test_meteor_without_nltk_names_it(monkeypatch):
    """nltk is imported at the first stem, and its absence says so."""
    monkeypatch.setattr(meteor, "_stemmer", None)
    monkeypatch.setitem(sys.modules, "nltk.stem.porter", None)  # import raises
    with pytest.raises(ImportError, match="nltk"):
        meteor.meteor_score(["a dog runs"], "the dogs ran")


def test_nocaps_conversion_and_offline_eval_equal_jax(tmp_path):
    ann = {"images": [{"id": i, "open_images_id": OPEN_ID[i], "domain": DOMAIN[i]} for i in GT],
           "annotations": [{"image_id": i, "caption": c, "id": 100 + 10 * i + j}
                           for i, caps in GT.items() for j, c in enumerate(caps)]}
    ann_file = tmp_path / "ann.json"
    ann_file.write_text(json.dumps(ann))
    rows = [f"{OPEN_ID[i]}\t" + json.dumps([{"caption": GT[i][0] if i != 3 else
                                              "a shiny accordion on the table"},
                                             {"caption": "WRONG second caption"}]) for i in GT]
    pred_file = tmp_path / "pred.tsv"
    pred_file.write_text("\n".join(rows) + "\n")
    preds = nocaps.convert_nocaps_predictions(str(pred_file), str(ann_file))
    assert preds == jax_nocaps.convert_nocaps_predictions(str(pred_file), str(ann_file))
    assert [p["image_id"] for p in preds] == [1, 2, 3, 4] and "WRONG" not in json.dumps(preds)
    out = nocaps.write_evalai_submission(preds, str(tmp_path / "sub.json"))
    assert json.load(open(out)) == preds
    got = nocaps.evaluate_nocaps_offline(str(pred_file), str(ann_file))
    assert got == jax_nocaps.evaluate_nocaps_offline(str(pred_file), str(ann_file))
    assert got["B1"]["in-domain"] == pytest.approx(1.0) and got["B1"]["out-domain"] < 1.0
    with pytest.raises(KeyError):
        bad = tmp_path / "bad.tsv"
        bad.write_text('oi_nope\t[{"caption": "x"}]\n')
        nocaps.convert_nocaps_predictions(str(bad), str(ann_file))


def test_flip_domain_metrics_equal_jax():
    response = [{"in-domain": {"CIDEr": 80.0, "SPICE": 11.0}},
                {"near-domain": {"CIDEr": 73.0, "SPICE": 10.5}},
                {"out-domain": {"CIDEr": 60.0, "SPICE": 9.0}},
                {"entire": {"CIDEr": 72.0, "SPICE": 10.4}}]
    flipped = nocaps.flip_domain_metrics(response)
    assert flipped == jax_nocaps.flip_domain_metrics(response)
    assert nocaps.flip_domain_metrics(response[::-1]) == flipped
    with pytest.raises(ValueError, match="missing domains"):
        nocaps.flip_domain_metrics(response[:2])


@pytest.fixture
def stub_java(tmp_path, monkeypatch):
    """Both packages' spice modules pointed at the stub interpreter and a
    placeholder jar."""
    stub = tmp_path / "fake_jvm.py"
    stub.write_text(STUB)
    jar = tmp_path / "fake.jar"
    jar.write_text("not a real jar")
    for mod in (spice, jax_spice):
        monkeypatch.setattr(mod, "JAVA", [sys.executable, str(stub)])
        monkeypatch.setattr(mod, "SPICE_JAR", str(jar))
        monkeypatch.setattr(mod, "CORENLP_JAR", str(jar))
    return stub


def test_ptb_tokenizer_protocol(stub_java, monkeypatch):
    caps = {"img1": [{"caption": "A Dog runs."}, {"caption": "Two cats,\nsitting!"}],
            "img2": [{"caption": "THE car."}]}
    out = spice.PTBTokenizer().tokenize(caps)
    assert out == {"img1": ["a dog runs", "two cats sitting"], "img2": ["the car"]}
    assert out == jax_spice.PTBTokenizer().tokenize(caps)
    monkeypatch.setenv("STUB_DROP_LINES", "1")
    with pytest.raises(RuntimeError, match="lines for"):
        spice.PTBTokenizer().tokenize({"a": [{"caption": "x y"}], "b": [{"caption": "z w"}]})


def test_ptb_and_spice_missing_jar_messages(tmp_path, monkeypatch):
    monkeypatch.setattr(spice, "CORENLP_JAR", str(tmp_path / "absent.jar"))
    monkeypatch.setattr(spice, "SPICE_JAR", str(tmp_path / "absent.jar"))
    with pytest.raises(FileNotFoundError, match="ALADIN_CORENLP_JAR"):
        spice.PTBTokenizer().tokenize({"a": [{"caption": "x"}]})
    with pytest.raises(FileNotFoundError, match="ALADIN_SPICE_JAR"):
        spice.Spice().compute_score({0: ["a dog"]}, {0: ["a dog"]})
    assert spice.java_available() == jax_spice.java_available()


def test_spice_protocol_equal_jax(stub_java):
    gts = {0: ["a dog runs fast", "the dog is running"], 1: ["a red car parked"]}
    res = {0: ["a dog runs fast"], 1: ["a blue boat"]}
    mean, results = spice.Spice().compute_score(gts, res)
    want_mean, want_results = jax_spice.Spice().compute_score(gts, res)
    assert mean == want_mean and results == want_results
    by_id = {r["image_id"]: r["scores"]["All"]["f"] for r in results}
    assert by_id[0] == 1.0 and 0.0 < by_id[1] < 0.5


@pytest.mark.parametrize("method", ["meteor", "spice"])
def test_meteor_and_spice_relevances_equal_jax(stub_java, tmp_path, method):
    """compute_relevances for both non-ROUGE methods: the raw float32
    memmaps equal aladin_tpu's."""
    want = jax_relevance.compute_relevances(QUERIES, IMAGES, str(tmp_path / "ref.npy"), method,
                                            num_workers=1)
    got = relevance.compute_relevances(QUERIES, IMAGES, str(tmp_path / "ours.npy"), method,
                                       num_workers=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    raw = np.fromfile(str(tmp_path / "ours.npy"), dtype=np.float32)  # no .npy header
    np.testing.assert_array_equal(raw.reshape(3, 4), np.asarray(want))
    assert want[0, 0] > want[0, 3]
