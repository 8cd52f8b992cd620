"""Image captioning in aladin_torch against aladin_tpu on the CPU: the
tensorizer, the captioner and its weight conversion, the label-smoothed
loss with and without drop-worst, the full-recompute decoders (greedy,
beam, top-k 1 sampling), token_logprobs and the SCST loss's gradient, the
sampling filter, the SCST rewards, the CLI helpers, and cli/captioning end
to end.

Both packages get the same seeded numpy inputs and the same weights: the
Flax parameters carried across by ``io/convert.py::task_state_dict_from_flax``.
Tiny dims (2 layers, width 32, 4 heads, a 21-word vocab), f32, dropout 0.
Tolerances:
  * tensorizer, rewards, helpers, filters' kept sets: equal;
  * captioner logits: 1e-5 (the same f32 math summed in another order);
  * captioning_loss: 1e-6;
  * decoders: tokens equal, scores and log-probs within 1e-5;
  * token_logprobs and the SCST loss's gradient: 1e-5.
Sampling draws cannot match across the packages (JAX's PRNG bits), so its
parity goes through top_k 1, where sampling equals greedy in both.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.cli import captioning as jax_cli
from aladin_tpu.data.tokenizer import BertWordPieceTokenizer as JaxTokenizer
from aladin_tpu.models.bert_img import BertImgConfig as JaxBertImgConfig
from aladin_tpu.tasks import captioning as jcap
from aladin_tpu.tasks.scst import ScstRewardCriterion as JaxScst
from aladin_torch.cli import captioning as cap_cli
from aladin_torch.data.tokenizer import BertWordPieceTokenizer
from aladin_torch.io.convert import (captioner_state_dict, load_captioner_checkpoint,
                                     task_state_dict_from_flax)
from aladin_torch.models.bert_img import BertImgConfig
from aladin_torch.tasks import captioning as cap
from aladin_torch.tasks.scst import ScstRewardCriterion, make_scst_step

VOCAB = {t: i for i, t in enumerate(
    "[PAD] [UNK] [CLS] [SEP] [MASK] a the dog cat runs sleeps photo of on in red blue big "
    "##gy tree car".split())}
TINY = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, img_feature_dim=12,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, MAX_SEQ_A, OD_W, IMG_W = 3, 7, 5, 4
OD_LENS, IMG_LENS = [5, 3, 2], [4, 2, 3]
IDS = dict(cls_id=VOCAB["[CLS]"], sep_id=VOCAB["[SEP]"], mask_id=VOCAB["[MASK]"],
           pad_id=VOCAB["[PAD]"])
KW = dict(max_steps=MAX_SEQ_A - 1, **IDS)
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: at these widths a second thread
    buys nothing, and the suite's workers share the box's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def decode_case(seed=0, b=B, feat_dim=TINY["img_feature_dim"]):
    """(od_ids, od_seg, feats, masks) numpy with other od / region lengths
    per example, the padded od slots zeroed as the CLI pads them."""
    rng = np.random.RandomState(seed)
    od_lens, img_lens = (OD_LENS * b)[:b], (IMG_LENS * b)[:b]
    od_ids = rng.randint(5, len(VOCAB), (b, OD_W)).astype(np.int32)
    od_seg = np.zeros((b, OD_W), np.int32)
    for i, n in enumerate(od_lens):
        od_ids[i, n:] = 0
        od_seg[i, :n] = 1
    feats = rng.randn(b, IMG_W, feat_dim).astype(np.float32)
    masks = np.stack([jcap._decode_attention_mask(MAX_SEQ_A, MAX_SEQ_A + OD_W, IMG_W, o, r)
                      for o, r in zip(od_lens, img_lens)])
    return od_ids, od_seg, feats, masks


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@functools.lru_cache(maxsize=None)
def captioner_pair(variant=(), sep_bias=2.5):
    """(aladin_tpu captioner, its params, the port's captioner loaded with
    them) for the TINY config updated by ``variant`` (a tuple of items).
    Every leaf moves off its init, and [SEP]'s decoder bias is raised so
    that some captions end before the last slot."""
    kw = {**TINY, **dict(variant)}
    jm = jcap.BertImageCaptioner(JaxBertImgConfig(**kw))
    od_ids, od_seg, feats, masks = decode_case()
    ids = np.concatenate([np.full((B, MAX_SEQ_A), IDS["mask_id"], np.int32), od_ids], 1)
    seg = np.concatenate([np.zeros((B, MAX_SEQ_A), np.int32), od_seg], 1)
    params = jax.jit(jm.init, static_argnums=5)(jax.random.PRNGKey(0), ids, masks, seg, feats,
                                                True)["params"]
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda x: x + jnp.asarray(0.05 * rng.randn(*x.shape), x.dtype), params)
    bias = params["cls"]["decoder_bias"].at[IDS["sep_id"]].add(sep_bias)
    params = {**params, "cls": {**params["cls"], "decoder_bias": bias}}
    tm = cap.BertImageCaptioner(BertImgConfig(**kw))
    tm.load_state_dict(task_state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm.eval()


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def test_caption_tensorizer_equal_jax():
    """Training and evaluation tensorization, with and without OD labels,
    over several calls of one RandomState: every array equal."""
    feats = np.random.RandomState(2).randn(6, 12).astype(np.float32)
    for is_train in (True, False):
        kw = dict(max_img_seq_length=4, max_seq_length=16, max_seq_a_length=8,
                  img_feature_dim=10, is_train=is_train, seed=3)
        ours = cap.CaptionTensorizer(BertWordPieceTokenizer(VOCAB), **kw)
        theirs = jcap.CaptionTensorizer(JaxTokenizer(VOCAB), **kw)
        for caption, od in (("the dog runs on a red car", "dog cat tree"),
                            ("a photo of the big doggy", None),
                            ("cat", "red blue big small tree car dog cat"),
                            ("a dog sleeps in the tree on the car", "car")):
            got, want = ours.tensorize(caption, od, feats), theirs.tensorize(caption, od, feats)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype


def test_captioner_converts_and_loads_without_missing_keys():
    """aladin_tpu's BertImageCaptioner tree (bert + cls, no
    seq_relationship) converts to exactly the port captioner's keys; an
    OSCAR captioning directory (with the tied decoder's copy and a
    pretraining head) loads through load_captioner_checkpoint."""
    jm, params, tm = captioner_pair()
    sd = task_state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    keys = cap.BertImageCaptioner(BertImgConfig(**TINY)).load_state_dict(sd, strict=True)
    assert not keys.missing_keys and not keys.unexpected_keys
    assert "cls.seq_relationship.weight" not in sd
    oscar = dict(sd)
    oscar["cls.predictions.decoder.weight"] = sd["bert.embeddings.word_embeddings.weight"]
    oscar["cls.seq_relationship.weight"] = torch.zeros(2, TINY["hidden_size"])
    assert set(captioner_state_dict(oscar)) == set(sd)


def test_load_captioner_checkpoint_dir(tmp_path):
    _, params, tm = captioner_pair()
    sd = task_state_dict_from_flax(jax.tree.map(np.asarray, params))
    sd["cls.predictions.decoder.weight"] = sd["bert.embeddings.word_embeddings.weight"]
    torch.save(sd, tmp_path / "pytorch_model.bin")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(BertImgConfig(**TINY).to_json_dict(), f)
    got, cfg = load_captioner_checkpoint(str(tmp_path))
    assert cfg == BertImgConfig(**TINY)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_captioner_logits_match_jax():
    """Every text position's logits within 1e-5; the rows that
    ``positions`` (an int, a (B, M) index tensor) pick equal those rows of
    the full output within 1e-6."""
    jm, params, tm = captioner_pair()
    od_ids, od_seg, feats, masks = decode_case(4)
    rng = np.random.RandomState(5)
    ids = np.concatenate([rng.randint(0, len(VOCAB), (B, MAX_SEQ_A)), od_ids], 1).astype(np.int32)
    seg = np.concatenate([np.zeros((B, MAX_SEQ_A), np.int32), od_seg], 1)
    want = jax.jit(jm.apply)({"params": params}, ids, masks, seg, feats)
    args = _t(ids, masks, seg, feats)
    with torch.no_grad():
        got = tm(*args)
        row = tm(*args, positions=3)
        midx = torch.tensor([[1, 4], [2, 0], [6, 6]])
        rows = tm(*args, positions=midx)
    assert got.shape == (B, MAX_SEQ_A + OD_W, len(VOCAB)) and got.dtype == torch.float32
    _close(got, want)
    _close(row, got[:, 3], atol=1e-6)
    _close(rows, torch.take_along_dim(got, midx[..., None], dim=1), atol=1e-6)
    _close(cap_cli.gather_masked(got, midx), jax_cli.gather_masked(np.asarray(want), midx.numpy()))


@pytest.mark.parametrize("drop", ["none", "drop_worst", "drop_worst_inactive", "all_inactive"])
def test_captioning_loss_matches_jax(drop):
    """The label-smoothed KL over active slots (target 0 = inactive), plain
    and drop-worst (0.3: keep floor(a * 0.7)), within 1e-6; a batch with no
    active slot gives 0 in both."""
    rng = np.random.RandomState(6)
    logits = (rng.randn(20, len(VOCAB)) * 3).astype(np.float32)
    targets = rng.randint(1, len(VOCAB), 20).astype(np.int32)
    targets[::4] = 0
    if drop == "all_inactive":
        targets[:] = 0
    ratio = 0.0 if drop == "none" else 0.3
    active = drop != "drop_worst_inactive"
    got = cap.captioning_loss(*_t(logits, targets), 0.1, ratio, active)
    want = jcap.captioning_loss(jnp.asarray(logits), jnp.asarray(targets), 0.1, ratio, active)
    assert np.isfinite(float(got))
    _close(got, want, atol=1e-6)
    if drop == "all_inactive":
        assert float(got) == 0.0 == float(want)


@pytest.mark.parametrize("mode", ["greedy", "beam1", "beam3"])
def test_full_recompute_decoders_match_jax(mode):
    """Greedy and beam search (widths 1 and 3): tokens equal, the summed
    log-prob / normalized score within 1e-5; greedy equals beam 1."""
    jm, params, tm = captioner_pair()
    inp = decode_case()
    if mode == "greedy":
        want = jcap.greedy_decode(jm, params, *inp, **KW)
        got = cap.greedy_decode(cap.StepInputs, tm, *_t(*inp), **KW)
        assert (got[0] == IDS["sep_id"]).any(1).sum() >= 1  # some caption ends early
    else:
        k = int(mode[-1])
        want = jcap.beam_search_decode(jm, params, *inp, num_beams=k, **KW)
        got = cap.beam_search_decode(cap.StepInputs, tm, *_t(*inp), num_beams=k, **KW)
        if k == 1:
            greedy = cap.greedy_decode(cap.StepInputs, tm, *_t(*inp), **KW)[0]
            np.testing.assert_array_equal(got[0].numpy(), greedy.numpy())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])


def test_top1_sampling_equals_greedy_in_both():
    """top_k 1 leaves one token a step: sampling is greedy decoding in both
    packages, whatever the draws."""
    jm, params, tm = captioner_pair()
    inp = decode_case()
    greedy = cap.greedy_decode(cap.StepInputs, tm, *_t(*inp), **KW)[0].numpy()
    for seed in (0, 1):
        gen = torch.Generator().manual_seed(seed)
        got = cap.sample_decode(cap.StepInputs, tm, *_t(*inp), gen, top_k=1, **KW)
        want = jcap.sample_decode(jm, params, *inp, jax.random.PRNGKey(seed), top_k=1, **KW)
        np.testing.assert_array_equal(got.numpy(), greedy)
        np.testing.assert_array_equal(np.asarray(want), greedy)


def test_sampling_draws_from_the_generator():
    """Unfiltered sampling: the same generator state draws the same
    captions, another state other ones."""
    _, _, tm = captioner_pair()
    inp = _t(*decode_case())

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return cap.sample_decode(cap.StepInputs, tm, *inp, gen, **KW)

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def _token_rows(seed=7):
    """Decoded-looking rows: CLS, random tokens, some ended by SEP + PAD."""
    rng = np.random.RandomState(seed)
    rows = rng.randint(5, len(VOCAB), (B, MAX_SEQ_A)).astype(np.int32)
    rows[:, 0] = IDS["cls_id"]
    rows[0, 3], rows[0, 4:] = IDS["sep_id"], IDS["pad_id"]
    rows[2, 5], rows[2, 6:] = IDS["sep_id"], IDS["pad_id"]
    return rows, rng.randn(B).astype(np.float32)


def test_token_logprobs_and_scst_gradient_match_jax():
    """token_logprobs of given rows (and their mask) within 1e-5; the SCST
    loss and its gradient for given advantages within 1e-5; summed over the
    mask, the greedy rows' log-probs are greedy_decode's own."""
    jm, params, tm = captioner_pair()
    inp = decode_case()
    rows, adv = _token_rows()
    lps, tmask = cap.token_logprobs(tm, *_t(rows, *inp), mask_id=IDS["mask_id"],
                                    pad_id=IDS["pad_id"])
    tm.zero_grad()
    loss = ScstRewardCriterion.loss(torch.from_numpy(adv), lps, tmask)
    loss.backward()

    def jloss(p):
        lp, m = jcap.token_logprobs(jm, p, rows, *inp, mask_id=IDS["mask_id"],
                                    pad_id=IDS["pad_id"])
        return JaxScst.loss(jnp.asarray(adv), lp, m), (lp, m)

    (want_loss, (want_lps, want_mask)), grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    _close(lps, want_lps)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(want_mask))
    _close(loss, want_loss)
    want_g = task_state_dict_from_flax(jax.tree.map(np.asarray, grads))
    for name, p in tm.named_parameters():  # the pooler takes no gradient
        _close(torch.zeros_like(p) if p.grad is None else p.grad, want_g[name], atol=ATOL)
    toks, logp = cap.greedy_decode(cap.StepInputs, tm, *_t(*inp), **KW)
    lp, m = cap.token_logprobs(tm, toks, *_t(*inp), mask_id=IDS["mask_id"], pad_id=IDS["pad_id"])
    _close((lp * m).sum(1), logp)


def test_scst_step_moves_parameters_by_the_loss_gradient():
    """make_scst_step: the loss is ScstRewardCriterion.loss of
    token_logprobs, and the update follows its gradient (AdamW's first step
    moves each live parameter by lr against the gradient's sign)."""
    from aladin_torch.cli.pretrain import make_optimizer

    _, params, _ = captioner_pair()
    tm = cap.BertImageCaptioner(BertImgConfig(**TINY))
    tm.load_state_dict(task_state_dict_from_flax(jax.tree.map(np.asarray, params)))
    inp = _t(*decode_case())
    rows, adv = _token_rows()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    lps, m = cap.token_logprobs(tm, torch.from_numpy(rows), *inp, mask_id=IDS["mask_id"],
                                pad_id=IDS["pad_id"])
    want = ScstRewardCriterion.loss(torch.from_numpy(adv), lps, m)
    opt, _ = make_optimizer(tm, 1e-3, 0, 10, weight_decay=0.0)
    got = make_scst_step(tm, opt, mask_id=IDS["mask_id"], pad_id=IDS["pad_id"])(
        torch.from_numpy(rows), torch.from_numpy(adv), *inp)["loss"]
    _close(got, want.detach(), atol=1e-6)
    w = "bert.encoder.layer.0.intermediate.dense.weight"
    p, g = dict(tm.named_parameters())[w], dict(tm.named_parameters())[w].grad
    live = g.abs() > 1e-3 * g.abs().max()
    torch.testing.assert_close((before[w] - p.detach())[live], 1e-3 * g.sign()[live],
                               rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("k,p", [(0, 1.0), (3, 1.0), (0, 0.6), (4, 0.8), (1, 1.0)])
def test_top_k_top_p_filtering_matches_jax(k, p):
    rng = np.random.RandomState(8)
    logits = rng.randn(5, len(VOCAB)).astype(np.float32)
    logits[1, 3] = logits[1, 7] = logits[1].max() + 1  # a tie at the top
    got = cap.top_k_top_p_filtering(torch.from_numpy(logits), k, p)
    want = np.asarray(jcap.top_k_top_p_filtering(jnp.asarray(logits), k, p))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scst_rewards_equal_jax():
    gts = [["a dog runs on the car", "the dog runs"], ["a cat sleeps", "the red cat sleeps"],
           ["a photo of a tree", "big tree"]]
    sampled = ["a dog runs", "the dog", "a cat", "cat sleeps in the tree", "a tree", "photo"]
    greedy = ["the dog runs", "a cat sleeps", "a tree"]
    for baseline in ("greedy", "sample_mean"):
        got = ScstRewardCriterion(baseline_type=baseline).rewards(sampled, greedy, gts)
        want = JaxScst(baseline_type=baseline).rewards(sampled, greedy, gts)
        np.testing.assert_array_equal(got, want)


def test_cli_helpers_equal_jax():
    """masked_positions, decode_inputs and detokenize of both CLIs."""
    mpos = np.array([[0, 1, 0, 1, 0, 1, 1], [0] * 7, [0, 0, 0, 0, 0, 0, 1]], np.int32)
    np.testing.assert_array_equal(cap_cli.masked_positions(mpos, 3),
                                  jax_cli.masked_positions(mpos, 3))
    kw = dict(max_img_seq_length=4, max_seq_length=12, max_seq_a_length=7, img_feature_dim=6)
    ours = cap.CaptionTensorizer(BertWordPieceTokenizer(VOCAB), **kw)
    theirs = jcap.CaptionTensorizer(JaxTokenizer(VOCAB), **kw)
    rng = np.random.RandomState(9)
    ods = ["dog cat tree car red", "", None]
    feats = [rng.randn(n, 8).astype(np.float32) for n in (6, 2, 3)]
    for g, w in zip(cap_cli.decode_inputs(ours.tok, ours, ods, feats),
                    jax_cli.decode_inputs(theirs.tok, theirs, ods, feats)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    rows = np.array([[2, 6, 7, 18, 9, 3, 6], [5, 3, 7, 0, 0, 0, 0], [2, 4, 4, 0, 0, 0, 0]])
    assert cap_cli.detokenize(ours.tok, rows) == jax_cli.detokenize(theirs.tok, rows)
    assert cap_cli.detokenize(ours.tok, rows)[0] == "the doggy runs"


CLI_DIMS = ["--synthetic", "--device", "cpu", "--epochs", "1", "--train_batch_size", "8",
            "--max_seq_length", "24", "--max_seq_a_length", "12", "--max_img_seq_length", "8",
            "--img_feature_dim", "16", "--learning_rate", "3e-3"]
CLI_MODES = {"greedy": [], "kv_cache": ["--kv_cache"], "beam3": ["--num_beams", "3"],
             "beam3_kv_cache": ["--num_beams", "3", "--kv_cache"], "cbs": ["--use_cbs"],
             "scst": ["--scst_epochs", "1"], "scst_kv_cache": ["--scst_epochs", "1", "--kv_cache"]}
# each --kv_cache mode and the full-recompute mode whose outputs it gives
KV_CACHE_TWIN = {"kv_cache": "greedy", "beam3_kv_cache": "beam3", "scst_kv_cache": "scst"}


@functools.lru_cache(maxsize=None)
def _cli_run(mode, out_dir):
    return cap_cli.run([*CLI_DIMS, "--output_dir", out_dir, *CLI_MODES[mode]])


@pytest.mark.parametrize("mode", sorted(CLI_MODES))
def test_captioning_cli_synthetic_cpu(tmp_path_factory, mode):
    """cli/captioning --synthetic --device cpu for one epoch: finite
    losses, one prediction an image in predictions.json, finite
    metrics in metrics.json; --kv_cache gives the full recompute's captions
    (and SCST losses) under greedy, beam 3 and SCST; --use_cbs captions
    hold a detected class word; SCST logs finite losses."""
    out = str(tmp_path_factory.mktemp(mode))
    res = _cli_run(mode, out)
    assert len(res["losses"]) == 1 and len(res["losses"][0]) == 5
    assert all(np.isfinite(res["losses"][0]))
    with open(os.path.join(out, "predictions.json")) as f:
        preds = json.load(f)
    assert [p["image_id"] for p in preds] == [str(100 + i) for i in range(8)]
    assert all(isinstance(p["caption"], str) for p in preds)
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    assert all(np.isfinite(metrics[k]) for k in ("Bleu_1", "ROUGE_L", "CIDEr"))
    assert res["model"].bert.cfg.num_hidden_layers == 2
    if mode in KV_CACHE_TWIN:
        twin = KV_CACHE_TWIN[mode]
        full = _cli_run(twin, str(tmp_path_factory.mktemp(twin + "_ref")))
        assert res["predictions"] == full["predictions"]
        assert res["scst_losses"] == full["scst_losses"]
    if mode.startswith("scst"):
        assert len(res["scst_losses"]) == 1 and all(np.isfinite(res["scst_losses"][0]))
    if mode == "cbs":
        from aladin_torch.tasks.task_inputs import ImageFeatureProvider

        prov = ImageFeatureProvider(os.path.join(out, "synthetic_caption", "features.tsv"))
        hits = sum(bool({o["class"] for o in prov.get_objects(p["image_id"])}
                        & set(p["caption"].split())) for p in preds)
        assert hits == len(preds)


@pytest.mark.parametrize("cli", ["captioning", "retrieval_oscar"])
def test_new_clis_need_cuda_unless_cpu_asked(cli, tmp_path):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the guard under test cannot fire")
    mod = importlib.import_module(f"aladin_torch.cli.{cli}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(["--synthetic", "--output_dir", str(tmp_path)])
