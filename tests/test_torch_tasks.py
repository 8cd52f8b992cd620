"""The OSCAR task slice of aladin_torch against aladin_tpu on the CPU: OSCAR+
pretraining (the model, its three losses, AdamW with WarmupLinearSchedule,
both decay masks, the corpus and its masking helpers), VQA / GQA / NLVR2
classification (the losses, the four heads, vqa_score), and cli/pretrain and
cli/classify end to end.

Both packages get the same seeded numpy inputs and the same weights: the
Flax parameters carried across by ``io/convert.py::task_state_dict_from_flax``.
Tiny dims (2 layers, width 64), f32, dropout 0. Tolerances:
  * logits and losses: rtol 1e-5 (atol 1e-6 for logits near 0), the same
    f32 math summed in another order;
  * AdamW: both optimizers take the same gradients (aladin_tpu's at its own
    parameters, carried across), so only the update arithmetic differs
    (optax's -lr * (u + wd * p) against torch's decay-then-step order, and
    the schedule in f32 against Python floats): parameters within 1e-6
    absolute after 3 steps;
  * decay masks, corpus collation, masking helpers: equal.
"""

import functools
import json
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.cli.common import build_tokenizer as jax_build_tokenizer
from aladin_tpu.cli.pretrain import make_optimizer as jax_make_optimizer
from aladin_tpu.cli.pretrain import warmup_linear_schedule as jax_warmup_linear
from aladin_tpu.config import DataArgs as JaxDataArgs
from aladin_tpu.models.bert_img import BertImgConfig as JaxBertImgConfig
from aladin_tpu.models.bert_img import ImageBertClassifier as JaxImageBertClassifier
from aladin_tpu.tasks import classification as jax_cls
from aladin_tpu.tasks import pretraining as jax_pt
from aladin_tpu.tasks.pretrain_data import PretrainCorpus as JaxPretrainCorpus
from aladin_tpu.tasks.pretrain_data import make_synthetic_pretrain_corpus as jax_make_corpus
from aladin_tpu.train.schedule import make_adamw as jax_make_adamw
from aladin_torch.cli import classify as classify_cli
from aladin_torch.cli import pretrain as pretrain_cli
from aladin_torch.cli.common import task_tokenizer
from aladin_torch.io.convert import task_state_dict_from_flax
from aladin_torch.models.bert_img import BertImgConfig, ImageBertClassifier
from aladin_torch.tasks import classification as cls
from aladin_torch.tasks import pretraining as pt
from aladin_torch.tasks.pretrain_data import PretrainCorpus, make_synthetic_pretrain_corpus
from aladin_torch.train.schedule import decay_mask, make_adamw, warmup_linear_schedule

TINY = dict(vocab_size=50, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=64, img_feature_dim=16,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, num_labels=7)
B, L, R = 4, 12, 6
RTOL = 1e-5
ADAM_ATOL = 1e-6


def _inputs(seed=0, choices=None):
    """(ids, mask, seg, feats) numpy, with a leading choices axis if given;
    ragged text and region lengths."""
    rng = np.random.RandomState(seed)
    lead = (B,) if choices is None else (B, choices)
    ids = rng.randint(5, TINY["vocab_size"], lead + (L,)).astype(np.int32)
    seg = (rng.rand(*lead, L) < 0.3).astype(np.int32)
    t_len = rng.randint(4, L + 1, lead)
    r_len = rng.randint(2, R + 1, lead)
    mask = np.concatenate([np.arange(L) < t_len[..., None], np.arange(R) < r_len[..., None]],
                          axis=-1).astype(np.int32)
    feats = rng.randn(*lead, R, TINY["img_feature_dim"]).astype(np.float32)
    return ids, mask, seg, feats


def _pretrain_labels(masked: bool, seed=1):
    rng = np.random.RandomState(seed)
    lm = np.full((B, L + R), -1, np.int32)
    if masked:
        pick = rng.rand(B, L) < 0.3
        lm[:, :L] = np.where(pick, rng.randint(0, TINY["vocab_size"], (B, L)), -1)
    return lm, rng.randint(0, 2, B).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# the four task models in both packages: (jax module, port module, inputs)
def _model_pair(name):
    jcfg, tcfg = JaxBertImgConfig(**TINY), BertImgConfig(**TINY)
    if name == "pretraining":
        return jax_pt.BertImgForPreTraining(jcfg), pt.BertImgForPreTraining(tcfg), _inputs()
    if name == "classifier":
        return JaxImageBertClassifier(jcfg), ImageBertClassifier(tcfg), _inputs()
    head, kind = name.split("_")
    if head == "mc":
        return (jax_cls.ImageBertForMultipleChoice(jcfg, classifier=kind),
                cls.ImageBertForMultipleChoice(tcfg, classifier=kind), _inputs(choices=2))
    return (jax_cls.OscarForMultipleChoice(jcfg, classifier=kind, num_labels=3),
            cls.OscarForMultipleChoice(tcfg, classifier=kind, num_labels=3), _inputs(choices=3))


def _perturbed(params, seed=2):
    """Every leaf moved off its init (so the zero-initialized biases, the
    MLM decoder_bias among them, feel weight decay)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: x + jnp.asarray(0.05 * rng.randn(*x.shape), x.dtype), params)


@functools.lru_cache(maxsize=None)
def _carried(name):
    """(jax module, Flax params, port module loaded with them, inputs), once
    a model; no test changes them."""
    jm, tm, inp = _model_pair(name)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), *inp)["params"])
    tm.load_state_dict(task_state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm.eval(), inp


HEADS = ["classifier", "mc_mlp", "mc_linear", "oscar_linear", "oscar_mlp"]


@pytest.fixture(scope="module")
def pretrain_pair():
    return _carried("pretraining")


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "no_masked_token"])
def test_pretraining_logits_and_losses_match_jax(pretrain_pair, masked):
    """Both logits and all three losses; with no masked token the MLM loss
    is 0 in both, not nan."""
    jm, params, tm, inp = pretrain_pair
    lm, nxt = _pretrain_labels(masked)
    want = jax.jit(jm.apply)({"params": params}, *inp)
    with torch.no_grad():
        got = tm(*_t(*inp))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-6)
    got_l = pt.pretraining_loss(*got, *_t(lm, nxt))
    want_l = jax_pt.pretraining_loss(*want, lm, nxt)
    for g, w in zip(got_l, want_l):
        assert np.isfinite(float(g)) and np.isfinite(float(w))
        _close(g, w)
    if not masked:
        assert float(got_l[1]) == 0.0 == float(want_l[1])


def test_warmup_linear_schedule_matches_jax():
    for warmup, total in ((2, 10), (0, 5), (10, 110)):
        ours, theirs = warmup_linear_schedule(1e-3, warmup, total), jax_warmup_linear(
            1e-3, warmup, total)
        for step in range(total + 3):
            assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6, abs=1e-12)
    s = warmup_linear_schedule(1.0, warmup_steps=10, total_steps=110)
    assert (s(5), s(10), s(60), s(110)) == (0.5, 1.0, 0.5, 0.0)


def _jax_optimizer(kind):
    """The optax transform: cli/pretrain's make_optimizer (its mask, the clip
    inside) or train/schedule's make_adamw behind the same clip."""
    sched = jax_warmup_linear(1e-2, 2, 10)
    if kind == "pretrain_mask":
        return jax_make_optimizer(1e-2, 2, 10, weight_decay=0.5, max_grad_norm=0.5)[0]
    return optax.chain(optax.clip_by_global_norm(0.5),
                       jax_make_adamw(sched, weight_decay=0.5))


@pytest.mark.parametrize("kind", ["pretrain_mask", "schedule_mask"])
def test_adamw_three_steps_match_optax(pretrain_pair, kind):
    """3 clipped AdamW steps (warmup 2, total 10, weight decay 0.5) from the
    same parameters on the same gradients: within 1e-6."""
    jm, params, _, inp = pretrain_pair
    _, tm, _ = _model_pair("pretraining")
    tm.load_state_dict(task_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    if kind == "pretrain_mask":
        opt, _ = pretrain_cli.make_optimizer(tm, 1e-2, 2, 10, weight_decay=0.5,
                                             max_grad_norm=0.5)
    else:
        opt = make_adamw(tm, warmup_linear_schedule(1e-2, 2, 10), weight_decay=0.5,
                         max_grad_norm=0.5)
    tx = _jax_optimizer(kind)
    opt_state = tx.init(params)
    lm, nxt = _pretrain_labels(True)

    def loss(p):
        return jax_pt.pretraining_loss(*jm.apply({"params": p}, *inp), lm, nxt)[0]

    named = dict(tm.named_parameters())
    grad_fn, update = jax.jit(jax.grad(loss)), jax.jit(tx.update)
    for _ in range(3):
        grads = grad_fn(params)
        for k, g in task_state_dict_from_flax(jax.tree.map(np.asarray, grads)).items():
            named[k].grad = g.clone()
        opt.step()
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    want = task_state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert opt.count == 3
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=0, atol=ADAM_ATOL,
                                   err_msg=k)


def _jax_decayed(jm, params, inp, kind):
    """aladin_tpu's mask, leaf by leaf, as port names -> decayed: one
    update from zero gradients moves exactly the decayed leaves."""
    if kind == "pretrain_mask":
        tx = jax_make_optimizer(1e-2, 0, 10, weight_decay=0.5)[0]
    else:
        tx = jax_make_adamw(lambda s: 1e-2, weight_decay=0.5)
    zeros = jax.tree.map(jnp.zeros_like, params)
    updates, _ = jax.jit(tx.update)(zeros, tx.init(params), params)
    moved = jax.tree.map(lambda u: np.full(u.shape, bool(np.any(np.asarray(u) != 0))), updates)
    return {k: bool(v.all()) for k, v in task_state_dict_from_flax(moved).items()}


@pytest.mark.parametrize("name", ["pretraining", "classifier", "mc_mlp", "oscar_linear"])
@pytest.mark.parametrize("kind", ["pretrain_mask", "schedule_mask"])
def test_decay_masks_match_jax_leaf_by_leaf(name, kind):
    jm, params, tm, inp = _carried(name)
    want = _jax_decayed(jm, params, inp, kind)
    got = decay_mask(tm, exclude_scales=(kind == "schedule_mask"))
    assert got == want
    assert not got["bert.embeddings.LayerNorm.weight"] and not got["bert.pooler.dense.bias"]
    assert got["bert.encoder.layer.0.attention.self.query.weight"]
    if name == "pretraining":  # aladin_tpu decays the MLM decoder_bias (ROADMAP.md §3)
        assert got["cls.predictions.bias"]
        assert not got["cls.predictions.transform.LayerNorm.weight"]


def test_decay_masks_differ_on_layernorm_scales_outside_bert_names():
    """The two masks differ where a LayerNorm's name lacks "layernorm"
    (torch's TransformerEncoderLayer norm1 / norm2): train/schedule.py's
    excludes its scale, cli/pretrain.py's decays it; biases never decay."""
    layer = torch.nn.TransformerEncoderLayer(8, 2, 16)
    with_scales, without = decay_mask(layer, True), decay_mask(layer, False)
    assert not with_scales["norm1.weight"] and without["norm1.weight"]
    assert not with_scales["self_attn.in_proj_bias"] and not without["norm2.bias"]
    assert with_scales["self_attn.in_proj_weight"] and without["linear1.weight"]


def test_random_word_mask_and_pollute_tags_equal_jax():
    ids = np.random.RandomState(3).randint(0, 40, 64).astype(np.int64)
    ids[::7] = 0  # [PAD]: never masked
    for seed in range(3):
        got = pt.random_word_mask(ids, 40, np.random.RandomState(seed), mask_id=4)
        want = jax_pt.random_word_mask(ids, 40, np.random.RandomState(seed), mask_id=4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        assert (got[1][::7] == -1).all() and (got[1] >= 0).any()
    tags = np.random.RandomState(4).randint(0, 40, (6, 5))
    for seed in range(3):
        got = pt.pollute_tags(tags, np.random.RandomState(seed))
        want = jax_pt.pollute_tags(tags, np.random.RandomState(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pretrain"))
    make_synthetic_pretrain_corpus(os.path.join(root, "torch"), feat_dim=16)
    jax_make_corpus(os.path.join(root, "jax"), feat_dim=16)
    return root


@pytest.mark.parametrize("kw", [{}, {"texta_false_prob": 0.5, "mask_loss_for_unmatched": False}],
                         ids=["default", "texta_false"])
def test_corpus_collate_equal_jax(corpus_root, kw):
    """Each package's fixture, tokenizer and corpus: the same arrays bit for
    bit for the same indices and epochs."""
    args = dict(seq_len=24, max_img_seq_length=8, img_feature_dim=16, seed=5, **kw)
    ours = PretrainCorpus(os.path.join(corpus_root, "torch"), task_tokenizer(""),
                          ("coco", "flickr30k"), **args)
    theirs = JaxPretrainCorpus(os.path.join(corpus_root, "jax"),
                               jax_build_tokenizer(JaxDataArgs()), ("coco", "flickr30k"), **args)
    assert len(ours) == len(theirs) == 12
    for idx, epoch in (([0, 3, 5, 11], 0), ([7, 7, 2], 3)):
        got, want = ours.collate(idx, epoch), theirs.collate(idx, epoch)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("loss_type", ["ce", "bce", "kl", "kl_zero_targets"])
def test_classification_loss_matches_jax(loss_type):
    rng = np.random.RandomState(6)
    logits = rng.randn(5, 7).astype(np.float32) * 3
    if loss_type == "ce":
        labels = rng.randint(0, 7, 5)
    else:
        labels = (rng.rand(5, 7) * (rng.rand(5, 7) < 0.3)).astype(np.float32)
        if loss_type == "kl_zero_targets":
            labels[1] = 0.0  # q log q taken as 0 where q is 0, a zero row gives 0
    kind = loss_type.split("_")[0]
    got = cls.classification_loss(*_t(logits, labels), kind)
    want = jax_cls.classification_loss(logits, labels, kind)
    assert np.isfinite(float(got))
    _close(got, want)


@pytest.mark.parametrize("name", HEADS)
def test_head_logits_match_jax(name):
    """ImageBertClassifier (its logits and sequence output) and both
    multiple-choice heads with both head types."""
    jm, params, tm, inp = _carried(name)
    with torch.no_grad():
        got = tm(*_t(*inp))
    want = jax.jit(jm.apply)({"params": params}, *inp)
    if name == "classifier":
        _close(got[0], want[0], atol=1e-6)
        _close(got[1], want[1], atol=1e-6)
        got, want = got[0], want[0]
    else:
        _close(got, want, atol=1e-6)
    lead = {"classifier": (B, 7), "mc": (B, 2), "oscar": (B, 3, 3)}[name.split("_")[0]]
    assert tuple(got.shape) == lead


def test_vqa_score_matches_jax():
    rng = np.random.RandomState(7)
    logits = rng.randn(6, 9).astype(np.float32)
    soft = (rng.rand(6, 9) * (rng.rand(6, 9) < 0.4)).astype(np.float32)
    _close(cls.vqa_score(*_t(logits, soft)), jax_cls.vqa_score(logits, soft))


def test_task_converter_round_trips_the_heads_names():
    """The converter names every parameter of each port model, no more."""
    for name in ["pretraining"] + HEADS:
        jm, tm, inp = _model_pair(name)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inp)["params"]
        sd = task_state_dict_from_flax(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes))
        assert set(sd) == set(tm.state_dict()), name


PRETRAIN_DIMS = ["--max_seq_length", "24", "--max_img_seq_length", "8", "--img_feature_dim",
                 "16", "--train_batch_size", "4"]


def test_pretrain_cli_synthetic_cpu(tmp_path, monkeypatch):
    """cli/pretrain --synthetic --device cpu: finite losses, the logged lr
    on the schedule, both checkpoints load back strictly. TensorBoard's
    writer is made unimportable, so the logger takes its no-op writer and
    this process imports no TensorFlow (the card's runs, tests/test_torch_gpu.py
    and chip_smoke.py, write real event files)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    res = pretrain_cli.run(["--synthetic", "--device", "cpu", "--max_iters", "6",
                            "--log_step", "3", "--ckpt_period", "3", "--warmup_steps", "2",
                            "--max_grad_norm", "1.0", "--output_dir", str(tmp_path),
                            *PRETRAIN_DIMS])
    sched = warmup_linear_schedule(5e-5, 2, 6)
    assert [r["iter"] for r in res["log"]] == [3, 6]
    for r in res["log"]:
        assert r["lr"] == sched(r["iter"] - 1)
        assert all(np.isfinite(v) for s in r["steps"] for v in s.values())
    assert [os.path.basename(p) for p in res["checkpoints"]] == ["ckpt_0000003.pth.tar",
                                                                 "ckpt_0000006.pth.tar"]
    cfg = res["model"].bert.cfg
    for path in res["checkpoints"]:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        fresh = pt.BertImgForPreTraining(cfg)
        fresh.load_state_dict(ckpt["model"], strict=True)
    assert not (tmp_path / "tb").exists()  # the no-op writer wrote nothing
    final = torch.load(res["checkpoints"][-1], map_location="cpu", weights_only=True)
    assert final["iteration"] == 6
    for k, v in res["model"].state_dict().items():
        torch.testing.assert_close(final["model"][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("task,epochs", [("vqa", 2), ("gqa", 1), ("nlvr", 1)])
def test_classify_cli_synthetic_cpu(tmp_path, task, epochs):
    """cli/classify --synthetic --device cpu: finite losses, a validation
    score in [0, 1] each epoch, one test prediction a test example."""
    res = classify_cli.run(["--task", task, "--synthetic", "--device", "cpu", "--epochs",
                            str(epochs), "--train_batch_size", "8", "--log_step", "2", "--do_test",
                            "--max_seq_length", "24", "--max_img_seq_length", "8",
                            "--img_feature_dim", "16", "--output_dir", str(tmp_path)])
    assert len(res["losses"]) == 4 * epochs and all(np.isfinite(res["losses"]))
    assert len(res["val_scores"]) == epochs and all(0.0 <= s <= 1.0 for s in res["val_scores"])
    with open(res["test_results"]) as f:
        preds = json.load(f)
    n_test = sum(1 for line in open(tmp_path / "synthetic_task" / f"{task}_test.jsonl")
                 if line.strip())
    assert len(preds) == n_test == 32
    assert {p["question_id"] for p in preds} == {f"test{i}" for i in range(32)}


@pytest.mark.parametrize("cli", [pretrain_cli, classify_cli], ids=["pretrain", "classify"])
def test_task_clis_need_cuda_unless_cpu_asked(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the guard under test cannot fire")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--synthetic", "--output_dir", str(tmp_path)])


def test_pretrain_step_matches_jax_step(pretrain_pair):
    """One make_pretrain_step against aladin_tpu's (AdamW, lr 1e-3, no
    warmup): the metrics within 1e-5, the parameters within 1e-6 where the
    gradient is live and within lr elsewhere (Adam's first step turns
    rounding noise of a near-zero gradient into an update of up to lr)."""
    jm, params, _, inp = pretrain_pair
    _, tm, _ = _model_pair("pretraining")
    tm.load_state_dict(task_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    lm, nxt = _pretrain_labels(True)
    opt, _ = pretrain_cli.make_optimizer(tm, 1e-3, 0, 10)
    metrics = pt.make_pretrain_step(tm, opt)(*_t(*inp, lm, nxt))
    tx = jax_make_optimizer(1e-3, 0, 10)[0]
    grads = jax.jit(jax.grad(lambda p: jax_pt.pretraining_loss(
        *jm.apply({"params": p}, *inp), lm, nxt)[0]))(params)
    jstep = jax_pt.make_pretrain_step(jm, tx)
    new, _, jmetrics = jstep(params, tx.init(params), *inp, lm, nxt, jax.random.PRNGKey(0))
    for k in ("loss", "mlm_loss", "rel_loss"):
        _close(metrics[k], jmetrics[k])
    want = task_state_dict_from_flax(jax.tree.map(np.asarray, new))
    g = task_state_dict_from_flax(jax.tree.map(np.asarray, grads))
    gmax = max(float(v.abs().max()) for v in g.values())
    for k, p in tm.named_parameters():
        diff = (p.detach() - want[k]).abs()
        live = g[k].abs() > 1e-4 * gmax
        assert not live.any() or float(diff[live].max()) <= ADAM_ATOL, k
        assert float(diff.max()) <= 1e-3 + 1e-6, k

