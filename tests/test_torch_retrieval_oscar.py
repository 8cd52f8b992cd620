"""The OSCAR pair-retrieval baseline in aladin_torch against aladin_tpu on
the CPU: pair sampling over each package's synthetic corpus (bit for bit),
the pair train step (ce and bce: loss, accuracy, gradients), the pair scorer of tasks/oscar_teacher.py (teacher_scores with
its attention block, cross_scores), the ranks of a pair-probability matrix,
and cli/retrieval_oscar end to end.

Weights: aladin_tpu's ImageBertClassifier parameters carried across by
``io/convert.py::task_state_dict_from_flax``; tiny dims (2 layers, width
32), f32, dropout 0. Tolerances: sampled pairs and ranks equal; losses,
gradients, probabilities and attentions within 1e-5.
"""

import functools
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.cli.common import build_tokenizer as jax_build_tokenizer
from aladin_tpu.config import DataArgs as JaxDataArgs
from aladin_tpu.data.dataset import RetrievalDataset as JaxRetrievalDataset
from aladin_tpu.data.dataset import make_synthetic_dataset as jax_make_synthetic
from aladin_tpu.models.bert_img import BertImgConfig as JaxBertImgConfig
from aladin_tpu.models.bert_img import ImageBertClassifier as JaxImageBertClassifier
from aladin_tpu.tasks import oscar_teacher as jteacher
from aladin_tpu.tasks import retrieval_oscar as jro
from aladin_torch.cli import retrieval_oscar as ro_cli
from aladin_torch.cli.common import build_tokenizer
from aladin_torch.cli.pretrain import make_optimizer
from aladin_torch.config import DataArgs
from aladin_torch.data.dataset import RetrievalDataset, make_synthetic_dataset
from aladin_torch.io.convert import task_state_dict_from_flax
from aladin_torch.models.bert_img import BertImgConfig, ImageBertClassifier
from aladin_torch.tasks import oscar_teacher as teacher
from aladin_torch.tasks import retrieval_oscar as ro
from tests.test_torch_captioning import one_torch_thread  # noqa: F401 (autouse)

SEQ, REG, FEAT = 16, 6, 12
SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=64, img_feature_dim=FEAT, num_labels=2,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ATOL = 1e-5
LR = 1e-3


def _args(cls, root):
    return cls(data_dir=root, img_feat_file=os.path.join(root, "features.tsv"),
               max_seq_length=SEQ, max_img_seq_length=REG, img_feature_dim=FEAT,
               add_od_labels=True)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(port train, port test, aladin_tpu train, aladin_tpu test), each
    package over its own synthetic corpus and tokenizer."""
    root = tmp_path_factory.mktemp("ro")
    make_synthetic_dataset(str(root / "torch"), n_images=8, feat_dim=FEAT)
    jax_make_synthetic(str(root / "jax"), n_images=8, feat_dim=FEAT)
    a, ja = _args(DataArgs, str(root / "torch")), _args(JaxDataArgs, str(root / "jax"))
    tok, jtok = build_tokenizer(a), jax_build_tokenizer(ja)
    return (RetrievalDataset(tok, a, "train", is_train=True),
            RetrievalDataset(tok, a, "test", is_train=False),
            JaxRetrievalDataset(jtok, ja, "train", is_train=True),
            JaxRetrievalDataset(jtok, ja, "test", is_train=False))


def test_sample_pairs_equal_jax(datasets):
    """Positives and negatives (caption or image swapped) bit for bit over
    consecutive draws of one RandomState."""
    ours, _, theirs, _ = datasets
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for idx in ([0, 7, 13, 39], [5, 5, 22]):
        got, want = ro.sample_pairs(ours, idx, r1), jro.sample_pairs(theirs, idx, r2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        assert list(got[4]) == [1, 0] * len(idx)


@functools.lru_cache(maxsize=None)
def classifier_pair(vocab_size):
    """(aladin_tpu ImageBertClassifier, its params moved off their init,
    the port's classifier loaded with them)."""
    jm = JaxImageBertClassifier(JaxBertImgConfig(vocab_size=vocab_size, **SMALL))
    ids = np.zeros((2, SEQ), np.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), ids, np.ones((2, SEQ + REG), np.int32), ids,
                              np.zeros((2, REG, FEAT), np.float32))["params"]
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda x: x + jnp.asarray(0.05 * rng.randn(*x.shape), x.dtype), params)
    return jm, params


def _port_model(vocab_size, params):
    tm = ImageBertClassifier(BertImgConfig(vocab_size=vocab_size, **SMALL))
    tm.load_state_dict(task_state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return tm


@pytest.mark.parametrize("loss_type", ["ce", "bce"])
def test_pair_step_matches_jax(datasets, loss_type):
    """One pair step on 4 anchors (8 rows): the loss, the accuracy and every
    gradient against aladin_tpu's loss (its pair step's loss function, at
    dropout 0); the AdamW update (lr 1e-3) moves each parameter by at most
    lr (tests/test_torch_tasks.py holds AdamW itself to optax's)."""
    ours = datasets[0]
    v = ours.tensorizer.tok.vocab_size
    jm, params = classifier_pair(v)
    batch = ro.sample_pairs(ours, [0, 9, 17, 30], np.random.RandomState(4))
    tm = _port_model(v, params)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt, _ = make_optimizer(tm, LR, 0, 10)
    m = ro.make_pair_train_step(tm, opt, loss_type)(*(torch.from_numpy(a) for a in batch))

    def jloss(p):  # aladin_tpu/tasks/retrieval_oscar.py::make_pair_train_step's loss_fn
        logits = jm.apply({"params": p}, *batch[:4], True, False)[0]
        if loss_type == "ce":
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, batch[4]).mean()
        else:
            onehot = jax.nn.one_hot(batch[4], logits.shape[-1])
            loss = optax.sigmoid_binary_cross_entropy(logits, onehot).mean() * logits.shape[-1]
        return loss, (jnp.argmax(logits, -1) == batch[4]).mean()

    (want_loss, want_acc), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    np.testing.assert_allclose(m["loss"].item(), float(want_loss), rtol=ATOL)
    assert m["acc"].item() == pytest.approx(float(want_acc))
    grads = task_state_dict_from_flax(jax.tree.map(np.asarray, grads))
    for name, p in tm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), grads[name].numpy(), atol=ATOL, err_msg=name)
        assert float((p.detach() - before[name]).abs().max()) <= LR * (1 + 1e-2) + 1e-6, name


def _pair_streams(ds, n_img, n_cap):
    """The (n_img * n_cap) joint streams, image major, numpy."""
    keys = ds.img_keys
    out = []
    for i in range(n_img):
        for c in range(n_cap):
            ex = ds.tensorizer.tensorize_joint(ds.captions[keys[c // 5]][c % 5],
                                               ds.get_od_labels(keys[i]), ds.get_image(keys[i]))
            out.append(ex[:4])
    return [np.stack(x) for x in zip(*out)]


def test_teacher_scores_and_attention_match_jax(datasets):
    """The B x B matched probabilities and the (B, B, W, R) head-mean
    text->region attention block of the last layer, B 4, chunk 8."""
    ours = datasets[0]
    v = ours.tensorizer.tok.vocab_size
    jm, params = classifier_pair(v)
    tm = _port_model(v, params)
    streams = _pair_streams(ours, 4, 4)
    got_p, got_a = teacher.teacher_scores(tm, *(torch.from_numpy(a) for a in streams), 4, chunk=8)
    want_p, want_a = jteacher.teacher_scores(jm, params, *(jnp.asarray(a) for a in streams), 4,
                                             chunk=8)
    assert got_a.shape == (4, 4, SEQ - 1, REG)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), atol=ATOL)


def test_cross_scores_and_ranks_match_jax(datasets):
    """The streamed N_img x N_cap probabilities (a chunk that does not
    divide the pairs) within 1e-5; ranks_from_pair_probs and evaluate_cross
    equal aladin_tpu's on them."""
    _, test_ds, _, jtest = datasets
    v = test_ds.tensorizer.tok.vocab_size
    jm, params = classifier_pair(v)
    tm = _port_model(v, params)
    keys = test_ds.img_keys

    def make_pair(i, c):
        ex = test_ds.tensorizer.tensorize_joint(test_ds.captions[keys[c // 5]][c % 5],
                                                test_ds.get_od_labels(keys[i]),
                                                test_ds.get_image(keys[i]))
        return ex[:4]

    got = teacher.cross_scores(tm, make_pair, 8, 40, chunk=48)
    want = jteacher.cross_scores(jm, params, make_pair, 8, 40, chunk=48)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for g, w in zip(ro.ranks_from_pair_probs(want, 5), jro.ranks_from_pair_probs(want, 5)):
        np.testing.assert_array_equal(g, w)
    res, jres = ro.evaluate_cross(tm, test_ds, chunk=64), jro.evaluate_cross(jm, params, jtest, 64)
    assert res.keys() == jres.keys()
    for k in res:
        assert res[k] == pytest.approx(jres[k], abs=1e-9), k


def test_scorer_refuses_fused_attention():
    """The pair scorer reads the attention probabilities: with
    fused_attention the backbone raises rather than score without them."""
    tm = ImageBertClassifier(BertImgConfig(vocab_size=30, fused_attention=True, **SMALL))
    ids = torch.zeros(2, SEQ, dtype=torch.long)
    with pytest.raises(ValueError, match="output_attentions"):
        teacher.make_pair_scorer(tm, SEQ)(ids, torch.ones(2, SEQ + REG), ids,
                                          torch.zeros(2, REG, FEAT))


@pytest.mark.parametrize("loss_type", ["ce", "bce"])
def test_retrieval_oscar_cli_synthetic_cpu(tmp_path, loss_type):
    """cli/retrieval_oscar --synthetic --device cpu for one epoch: finite
    losses, accuracies in [0, 1], R@K in eval_results.json."""
    res = ro_cli.run(["--synthetic", "--device", "cpu", "--epochs", "1", "--train_batch_size",
                      "8", "--max_seq_length", "24", "--max_img_seq_length", "8",
                      "--img_feature_dim", "16", "--loss_type", loss_type, "--output_dir",
                      str(tmp_path)])
    assert len(res["metrics"]) == 5
    assert all(np.isfinite(m["loss"]) and 0.0 <= m["acc"] <= 1.0 for m in res["metrics"])
    with open(tmp_path / "eval_results.json") as f:
        out = json.load(f)
    assert out == res["results"]
    assert 0.0 <= out["rsum"] <= 600.0 and {"i2t_r1", "t2i_r10", "i2t_medr"} <= set(out)
    assert res["batch"][0].shape == (16, 24)
