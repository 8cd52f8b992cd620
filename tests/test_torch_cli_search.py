"""cli/search end to end on the CPU: aladin_torch.cli.search build, query,
curve and the index guard (tests/test_cli_search.py's cases without the
mesh), and the two packages on each other's indexes.

An index either package writes loads in the other, and by-row queries and
the curve table agree on it: the same image keys and captions in the same
order, scores within 1e-4 before the CLI rounds them to 4 decimals (so
within 1e-4 after). Free-text queries agree on a checkpoint that both
packages load (f32 encoders).
"""

import json
import os
import shutil

import numpy as np
import pytest

import jax

from aladin_torch.cli import search as torch_search
from aladin_torch.eval.index import IndexCompatError, load_index
from aladin_tpu.cli import search as jax_search
from aladin_tpu.cli.common import build_tokenizer as jax_build_tokenizer
from aladin_tpu.cli.common import prepare_synthetic as jax_prepare_synthetic
from aladin_tpu.config import DataArgs as JaxDataArgs
from aladin_tpu.config import ExperimentConfig as JaxExperimentConfig
from aladin_tpu.data.dataset import RetrievalDataset as JaxRetrievalDataset
from aladin_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from aladin_tpu.eval.index import load_index as jax_load_index
from aladin_tpu.io.convert import save_aladin_checkpoint
from aladin_tpu.models.aladin import ALADIN as JaxALADIN
from aladin_tpu.models.bert_img import BertImgConfig as JaxBertImgConfig

CONFIG = "aladin_torch/configs/alad-alignment-and-matching-distill.json"
DIMS = ["--max_seq_length", "20", "--max_img_seq_length", "12", "--img_feature_dim", "32"]
RECIPE = {"dataset": {"name": "coco"},
          "model": {"embed-size": 32, "tern-layers": 2, "teran-layers": 0, "dropout": 0.1},
          "training": {"loss-type": "alignment-distillation", "loss-weights": [1, 1], "bs": 8}}
# 4-decimal rounding of two scores within 1e-4 leaves them within 1e-4
SCORE_TOL = 1e-4 + 1e-9


def _build(main, work, name, *flags):
    idx = os.path.join(work, name)
    out = os.path.join(work, name + "_run")
    assert main(["build", "--index_dir", idx, "--output_dir", out, "--logger_name", out,
                 "--synthetic", *DIMS, *flags]) == 0
    return idx


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_search"))


@pytest.fixture(scope="module")
def index_dir(work):
    """An index the port built (random synthetic backbone, bf16 encoder)."""
    return _build(torch_search.main, work, "idx", "--config", CONFIG, "--device", "cpu")


@pytest.fixture(scope="module")
def checkpoint(work):
    """A .pth.tar of seeded aladin_tpu parameters with the --synthetic
    backbone's shapes (vocab 512, 2 layers, 4 heads, FFN 2 x embed)."""
    args = jax_prepare_synthetic(JaxDataArgs(output_dir=os.path.join(work, "fixture"),
                                             max_seq_length=20, max_img_seq_length=12,
                                             img_feature_dim=32))
    ds = JaxRetrievalDataset(jax_build_tokenizer(args), args, "test", is_train=False)
    example = next(iter(JaxBatchLoader(ds, 8, shuffle=False, drop_last=False).epoch(0)))
    bert = JaxBertImgConfig(vocab_size=512, hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=64,
                            max_position_embeddings=128, img_feature_dim=32)
    model = JaxALADIN(JaxExperimentConfig.from_dict(RECIPE), bert)
    params = model.init(jax.random.PRNGKey(3), example, True)["params"]
    path = os.path.join(work, "model_best_rsum.pth.tar")
    save_aladin_checkpoint(path, jax.tree.map(np.asarray, params), RECIPE)
    return path


@pytest.fixture(scope="module")
def jax_index_dir(work, checkpoint):
    """An index aladin_tpu built from the checkpoint with an f32 encoder."""
    return _build(jax_search.main, work, "jax_idx", "--load_checkpoint", checkpoint,
                  "--compute_dtype", "float32")


def _query(main, index_dir, tmp_path, name, *flags, device=True):
    out = str(tmp_path / f"{name}.json")
    argv = ["query", "--index_dir", index_dir, *flags, "--out", out]
    assert main(argv + (["--device", "cpu"] if device else [])) == 0
    with open(out) as f:
        return json.load(f)


def _assert_same_hits(got, want):
    assert [r["query"] for r in got] == [r["query"] for r in want]
    for g, w in zip(got, want):
        assert [{k: v for k, v in h.items() if k != "score"} for h in g["hits"]] == \
            [{k: v for k, v in h.items() if k != "score"} for h in w["hits"]]
        np.testing.assert_allclose([h["score"] for h in g["hits"]],
                                   [h["score"] for h in w["hits"]], atol=SCORE_TOL, rtol=0)


def test_index_contents(index_dir):
    index = load_index(index_dir)
    assert index.n_images == 8 and index.n_captions == 40
    assert index.captions_per_img == 5
    assert len(index.meta["img_keys"]) == 8 and len(index.meta["captions"]) == 40
    np.testing.assert_allclose(np.linalg.norm(index.img_glob, axis=-1), 1.0, atol=1e-2)


def test_query_matching_only_is_argsort(index_dir, tmp_path):
    """--no_rerank hits equal a stable numpy argsort over the stored globals."""
    index = load_index(index_dir)
    rows = [0, 7, 23]
    results = _query(torch_search.main, index_dir, tmp_path, "res", "--direction", "t2i",
                     *[a for r in rows for a in ("--query_index", str(r))], "--k", "8",
                     "--no_rerank")
    sims = index.cap_glob @ index.img_glob.T
    for res, row in zip(results, rows):
        got = [index.meta["img_keys"].index(h["image_key"]) for h in res["hits"]]
        assert got == np.argsort(-sims[row], kind="stable").tolist()


def test_free_text_query_matches_by_row(index_dir, tmp_path):
    """The exact text of caption row 11 reproduces the by-row hits."""
    text = load_index(index_dir).meta["captions"][11]
    by_text = _query(torch_search.main, index_dir, tmp_path, "t", "--text", text, "--k", "3",
                     "--shortlist", "8")[0]["hits"]
    by_row = _query(torch_search.main, index_dir, tmp_path, "r", "--query_index", "11", "--k",
                    "3", "--shortlist", "8")[0]["hits"]
    assert [h["image_key"] for h in by_text] == [h["image_key"] for h in by_row]
    for a, b in zip(by_text, by_row):  # a fresh encode vs the f16-stored row
        assert abs(a["score"] - b["score"]) < 5e-2, (a, b)


def test_query_i2t_direction(index_dir, tmp_path):
    hits = _query(torch_search.main, index_dir, tmp_path, "i2t", "--direction", "i2t",
                  "--query_index", "2", "--k", "5")[0]["hits"]
    assert len(hits) == 5 and all("caption" in h and "image_key" in h for h in hits)


def test_curve(index_dir, tmp_path):
    out = str(tmp_path / "curve.json")
    assert torch_search.main(["curve", "--index_dir", index_dir, "--shortlists", "2,4",
                              "--ks", "1,5", "--out", out, "--device", "cpu"]) == 0
    with open(out) as f:
        table = json.load(f)
    assert table["ks"] == [1, 5]
    stages = {(r["direction"], r["stage"]) for r in table["rows"]}
    for d in ("t2i", "i2t"):
        for stage in ("matching-only", "rerank@2", "rerank@4", "full-rerank"):
            assert (d, stage) in stages
    for r in table["rows"]:
        assert all(0.0 <= v <= 100.0 for v in r["recall"].values())
        assert r["recall"]["5"] >= r["recall"]["1"]


def test_index_compat_guard(index_dir, tmp_path):
    """Stale, future, mixed or truncated indexes refuse with a clear error;
    the CLI exits 2."""
    load_index(index_dir)

    def clone(name, edit=None):
        d = str(tmp_path / name)
        shutil.copytree(index_dir, d)
        if edit:
            p = os.path.join(d, "index_meta.json")
            with open(p) as f:
                meta = json.load(f)
            edit(meta)
            with open(p, "w") as f:
                json.dump(meta, f)
        return d

    stale = clone("stale", lambda m: m.pop("format_version"))
    with pytest.raises(IndexCompatError, match="pre-versioning"):
        load_index(stale)
    with pytest.raises(IndexCompatError, match="version 99"):
        load_index(clone("future", lambda m: m.update(format_version=99)))
    with pytest.raises(IndexCompatError, match="different builds"):
        load_index(clone("mixed", lambda m: m.update(checkpoint="other.pth.tar",
                                                     fingerprint="0" * 64)))
    broken = clone("broken")
    with open(os.path.join(broken, "embeddings.npz"), "r+b") as f:
        f.truncate(100)
    with pytest.raises(IndexCompatError, match="corrupt or truncated"):
        load_index(broken)
    assert torch_search.main(["query", "--index_dir", stale, "--query_index", "0",
                              "--device", "cpu"]) == 2


def test_port_index_loads_in_jax(index_dir, tmp_path):
    """aladin_tpu loads the port's index: the same buffers, and its by-row
    hits equal the port's."""
    ours, theirs = load_index(index_dir), jax_load_index(index_dir)
    assert theirs.meta == ours.meta
    for key in ("img_sets", "img_lens", "cap_sets", "cap_lens", "img_glob", "cap_glob"):
        np.testing.assert_array_equal(getattr(theirs, key), getattr(ours, key))
    flags = ("--query_index", "3", "--query_index", "11", "--k", "5", "--shortlist", "6")
    _assert_same_hits(_query(torch_search.main, index_dir, tmp_path, "t", *flags),
                      _query(jax_search.main, index_dir, tmp_path, "j", *flags, device=False))


@pytest.mark.parametrize("direction,rerank", [("t2i", True), ("t2i", False), ("i2t", True)])
def test_jax_index_queries_match_jax(jax_index_dir, tmp_path, direction, rerank):
    """By-row queries on aladin_tpu's index: the port's hits equal aladin_tpu's."""
    flags = ("--direction", direction, "--query_index", "0", "--query_index", "7",
             "--query_index", "6", "--k", "5", "--shortlist", "6",
             *(() if rerank else ("--no_rerank",)))
    _assert_same_hits(_query(torch_search.main, jax_index_dir, tmp_path, "t", *flags),
                      _query(jax_search.main, jax_index_dir, tmp_path, "j", *flags,
                             device=False))


def test_jax_index_curve_matches_jax(jax_index_dir, tmp_path):
    outs = {}
    for name, main, extra in (("t", torch_search.main, ["--device", "cpu"]),
                              ("j", jax_search.main, [])):
        outs[name] = str(tmp_path / f"{name}.json")
        assert main(["curve", "--index_dir", jax_index_dir, "--shortlists", "2,4,10",
                     "--out", outs[name], *extra]) == 0
    with open(outs["t"]) as f, open(outs["j"]) as g:
        assert json.load(f) == json.load(g)


def test_free_text_hits_match_jax(jax_index_dir, tmp_path):
    """Free text on an index with a checkpoint both packages load: the
    port's f32 query encoder gives aladin_tpu's hits."""
    index = load_index(jax_index_dir)
    flags = ("--text", index.meta["captions"][11], "--text", "a photo of the dog",
             "--k", "5", "--shortlist", "6")
    _assert_same_hits(_query(torch_search.main, jax_index_dir, tmp_path, "t", *flags),
                      _query(jax_search.main, jax_index_dir, tmp_path, "j", *flags,
                             device=False))


def test_search_cli_needs_cuda_unless_cpu_asked(index_dir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the guard under test cannot fire")
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_search.main(["query", "--index_dir", index_dir, "--query_index", "0"])
