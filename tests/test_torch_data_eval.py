"""The port's data path and evaluation against aladin_tpu on the CPU.

Loaders and tokenizers must yield identical arrays; ranks, recall and the
5-fold metrics on one score matrix must be exactly equal (integer counts
of strictly greater scores); encode buffers agree within 1e-4 (the same f32
forward summed in another order).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.cli.common import build_tokenizer as jax_build_tokenizer
from aladin_tpu.config import DataArgs as JaxDataArgs
from aladin_tpu.config import ExperimentConfig as JaxExperimentConfig
from aladin_tpu.data.dataset import RetrievalDataset as JaxRetrievalDataset
from aladin_tpu.data.dataset import make_synthetic_dataset as jax_make_synthetic
from aladin_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from aladin_tpu.eval import encode as jenc
from aladin_tpu.eval import recall as jrec
from aladin_tpu.eval import retrieval as jret
from aladin_tpu.models.aladin import ALADIN as JaxALADIN
from aladin_tpu.models.bert_img import BertImgConfig as JaxBertImgConfig
from aladin_tpu.train.step import make_eval_step
from aladin_torch.cli.common import build_tokenizer
from aladin_torch.config import DataArgs, ExperimentConfig
from aladin_torch.data.dataset import RetrievalDataset, make_synthetic_dataset
from aladin_torch.data.pipeline import BatchLoader
from aladin_torch.eval import encode as tenc
from aladin_torch.eval import recall as trec
from aladin_torch.eval import retrieval as tret
from aladin_torch.io.convert import state_dict_from_flax
from aladin_torch.models.aladin import ALADIN, Batch
from aladin_torch.models.bert_img import BertImgConfig

FEAT = 24
FIELDS = tuple(Batch.__dataclass_fields__)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One synthetic corpus (written by aladin_tpu) and both datasets on it."""
    root = str(tmp_path_factory.mktemp("corpus"))
    jax_make_synthetic(root, n_images=12, feat_dim=FEAT, max_boxes=9)
    common = dict(data_dir=root, img_feat_file=os.path.join(root, "features.tsv"),
                  max_seq_length=16, max_img_seq_length=8, img_feature_dim=FEAT,
                  add_od_labels=True)
    jargs, targs = JaxDataArgs(**common), DataArgs(**common)
    jds = JaxRetrievalDataset(jax_build_tokenizer(jargs), jargs, "test", is_train=False)
    tds = RetrievalDataset(build_tokenizer(targs), targs, "test", is_train=False)
    return root, jds, tds


def test_synthetic_writers_identical(corpus, tmp_path):
    root, _, _ = corpus
    make_synthetic_dataset(str(tmp_path), n_images=12, feat_dim=FEAT, max_boxes=9)
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name


def test_tokenizers_identical(corpus):
    _, jds, tds = corpus
    for text in ("A photo of the dog, number 7!", "unknownword cat", "  tree\tHOUSE  "):
        assert tds.tensorizer.tok.tokenize(text) == jds.tensorizer.tok.tokenize(text)
        assert (tds.tensorizer.tok.encode_trunc(text, 4)
                == jds.tensorizer.tok.encode_trunc(text, 4))


@pytest.mark.parametrize("sorted_trimmed", [False, True])
def test_batch_loaders_yield_identical_arrays(corpus, sorted_trimmed):
    _, jds, tds = corpus
    kw = dict(shuffle=False, drop_last=False, sort_by_length=sorted_trimmed,
              trim_multiple=4 if sorted_trimmed else 0)
    jbatches = list(JaxBatchLoader(jds, 7, **kw).epoch(0))
    tbatches = list(BatchLoader(tds, 7, device="cpu", **kw).epoch(0))
    assert len(jbatches) == len(tbatches) == 9
    for jb, tb in zip(jbatches, tbatches):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))


def test_shuffled_loader_order_matches():
    class Rows:
        def __len__(self):
            return 23

    a = BatchLoader(Rows(), 5, shuffle=True, seed=4).row_order(2)
    b = JaxBatchLoader(Rows(), 5, shuffle=True, seed=4).row_order(2)
    np.testing.assert_array_equal(a, b)


def _score_matrix(rng, n=20, k=5):
    """Scores with exact ties (coarse rounding) so the tie rule is exercised."""
    return np.round(rng.randn(n, n * k), 1).astype(np.float32)


def test_ranks_and_recall_exact(rng):
    s = _score_matrix(rng)
    ti2t, tt2i = trec.ranks_from_score_matrix(torch.from_numpy(s))
    ji2t, jt2i = jrec.ranks_from_score_matrix(jnp.asarray(s))
    np.testing.assert_array_equal(ti2t.numpy(), np.asarray(ji2t))
    np.testing.assert_array_equal(tt2i.numpy(), np.asarray(jt2i))
    assert trec.recall_metrics(ti2t.numpy()) == jrec.recall_metrics(np.asarray(ji2t))
    assert tret.retrieval_metrics_from_scores(torch.from_numpy(s)) == \
        jret.retrieval_metrics_from_scores(s)


def test_fivefold_exact(rng):
    s = _score_matrix(rng, n=10)
    assert tret.fivefold_from_scores(torch.from_numpy(s), n_folds=2) == \
        jret.fivefold_from_scores(s, n_folds=2)


def test_recall_from_embeddings(rng):
    """Matching-head recall and the 5 x 1k protocol on grouped embeddings
    (exact: the small f32 products are computed identically here)."""
    img = np.repeat(rng.randn(12, 8), 5, axis=0).astype(np.float32)
    cap = rng.randn(60, 8).astype(np.float32)
    assert trec.compute_recall(img, cap, device="cpu") == jrec.compute_recall(img, cap)
    assert (trec.recall_1k_5fold(img, cap, fold=20, device="cpu")
            == jrec.recall_1k_5fold(img, cap, fold=20))


def test_recall_beyond_dense_limit_raises(monkeypatch, rng):
    """Beyond the dense limit compute_recall no longer raises: it streams
    (eval/streaming.py) and returns the dense path's dict and aladin_tpu's."""
    img = np.repeat(rng.randn(2, 4), 5, axis=0).astype(np.float32)
    cap = rng.randn(10, 4).astype(np.float32)
    want = trec.compute_recall(img, cap, device="cpu")
    monkeypatch.setattr(trec, "STREAMING_SCORE_BYTES", 16)
    assert trec.compute_recall(img, cap, device="cpu") == want == jrec.compute_recall(img, cap)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_alignment_head_matches(rng, dtype):
    """CPU: f32 scores through score_all_pairs (aladin_tpu's XLA path),
    int8 through the kernel's plain version (aladin_tpu's interpreted
    kernel); atol 1e-5, metrics exactly equal."""
    img = np.repeat(rng.randn(6, 9, 16), 5, axis=0).astype(np.float32)
    cap = rng.randn(30, 11, 16).astype(np.float32)
    il = np.repeat(rng.randint(2, 10, 6), 5).astype(np.int32)
    cl = rng.randint(4, 12, 30).astype(np.int32)
    jdt = jnp.int8 if dtype == "int8" else None
    tdt = torch.int8 if dtype == "int8" else None
    ji2t, jt2i, js = jret.evaluate_alignment_head(img, cap, il, cl, use_pallas=False,
                                                  compute_dtype=jdt)
    ti2t, tt2i, ts = tret.evaluate_alignment_head(img, cap, il, cl, compute_dtype=tdt,
                                                  device="cpu")
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert ti2t == ji2t and tt2i == jt2i


# caption lengths (specials included) in a 50-slot buffer: "buckets" fills the 16- and
# 32-slot widths, has a 48-slot sliver (2 of 60, under 4%) that merges into the widest,
# 50; "one_call" is long enough that bucketing would save under 25%
SCORE_FN_LENGTHS = {"buckets": [5] * 10 + [16] * 20 + [17] * 7 + [32] * 20 + [40, 48, 50],
                    "one_call": [45] * 30 + [50] * 30}


@pytest.mark.parametrize("case", sorted(SCORE_FN_LENGTHS))
def test_score_fn_called_as_in_jax(rng, case):
    """A custom score_fn gets the same calls from both packages'
    evaluate_alignment_head: the same caption widths and lengths, in the
    same order; the scores within 1e-5 (f32 MrSw in each package)."""
    from aladin_tpu.ops import alignment as jal
    from aladin_torch.ops import alignment as tal

    cl = rng.permutation(SCORE_FN_LENGTHS[case]).astype(np.int32)
    img = np.repeat(rng.randn(12, 9, 16), 5, axis=0).astype(np.float32)
    cap = rng.randn(60, 50, 16).astype(np.float32)
    il = np.repeat(rng.randint(2, 10, 12), 5).astype(np.int32)
    calls = {"jax": [], "torch": []}

    def recorder(name, score):
        def score_fn(ims, caps, im_len, cap_len):
            calls[name].append((ims.shape[0], caps.shape[1], np.asarray(cap_len).tolist()))
            return score(ims, caps, im_len, cap_len, "MrSw")
        return score_fn

    _, _, js = jret.evaluate_alignment_head(img, cap, il, cl, use_pallas=False,
                                            score_fn=recorder("jax", jal.alignment_scores))
    _, _, ts = tret.evaluate_alignment_head(img, cap, il, cl, device="cpu",
                                            score_fn=recorder("torch", tal.alignment_scores))
    assert calls["torch"] == calls["jax"]
    want_widths = [16, 32, 50] if case == "buckets" else [50]
    assert [w for _, w, _ in calls["torch"]] == want_widths
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_encode_buffers_match(corpus, rng):
    """encode_data over the same loader rows with carried weights: global
    embedding packed in slot 0, buffers within 1e-4, lengths equal."""
    _, jds, tds = corpus
    small = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, max_position_embeddings=32, img_feature_dim=FEAT)
    d = {"model": {"embed-size": 32, "tern-layers": 1},
         "training": {"loss-type": "alignment-distillation", "loss-weights": [1, 1], "bs": 7}}
    jmodel = JaxALADIN(JaxExperimentConfig.from_dict(d), JaxBertImgConfig(**small))
    jloader = JaxBatchLoader(jds, 7, shuffle=False, drop_last=False)
    params = jmodel.init(jax.random.PRNGKey(0), next(iter(jloader.epoch(0))), True)["params"]
    want = jenc.encode_data(make_eval_step(jmodel), params, jloader, buffer_len=17)

    model = ALADIN(ExperimentConfig.from_dict(d), BertImgConfig(**small))
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    got = tenc.encode_data(model, BatchLoader(tds, 7, shuffle=False, drop_last=False),
                           buffer_len=17)
    assert got[0].shape == (60, 17, 32)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
