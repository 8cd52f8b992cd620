"""The int8 serving encoder's plain versions against aladin_tpu, on the CPU.

Same numpy inputs from a seed through both packages:

  * ``quantize_rowwise``: q and s exactly equal, zero rows 0 and finite;
  * K4 (``w8a8_matmul_plain``) against ``w8a8_matmul(..., interpret=True)``:
    rtol 1e-6 with f32 output and no activation (the int32 sums are exact,
    only the f32 epilogue rounds), atol 1e-5 with gelu / gelu_tanh (the
    Pallas kernel's A&S erf is within 1.5e-7 of the exact erf);
  * K4-dynx (``w8a8_matmul_dynx_plain``) against
    ``w8a8_matmul_dynx(..., interpret=True)`` (the same reciprocal-multiply
    scale: rtol 1e-6), also as the card runs it (``w8a8_quantize`` then
    K4, bitwise equal to the dynx plain version), and ``w8a8_apply``
    against aladin_tpu's CPU ``w8a8_apply``, which scales by division, so a
    scale can differ by one f32 ulp: rtol 1e-5;
  * K3b (``residual_layernorm_q8_plain``) against
    ``residual_layernorm_q8`` with impl "interpret" and "xla": y within K3a's
    tolerances (2e-5 in f32, 1e-2 for bf16 x), s within rtol 1e-6, q at most
    one step apart; ``layernorm_q8`` exactly;
  * the backbone (2 layers, hidden 64) with ``quant_matmuls``, alone and
    with ``fused_layernorm``, against aladin_tpu's at f32, dropout 0, same
    weights: within 1e-3 of the largest output;
  * ``QuantLinear``: nn.Linear's state dict, f32 weights through a bf16
    cast and a later checkpoint load, and the retrieval-order property of
    tests/test_quant.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.models.bert_img import BertImgConfig as JaxBertImgConfig
from aladin_tpu.models.bert_img import BertImgModel as JaxBertImgModel
from aladin_tpu.models.quant import quantize_rowwise as jax_quantize_rowwise
from aladin_tpu.models.quant import w8a8_apply as jax_w8a8_apply
from aladin_tpu.ops.pallas import layernorm as jax_ln
from aladin_tpu.ops.pallas import quant_matmul as jax_qm
from aladin_torch.cli.common import build_model
from aladin_torch.config import DataArgs, load_config
from aladin_torch.io.convert import bert_state_dict
from aladin_torch.models.bert_img import BertImgConfig, BertImgModel
from aladin_torch.models.quant import QuantLinear, quantize_rowwise, w8a8_apply, w8a8_apply_xq
from aladin_torch.ops.kernels import layernorm as lk
from aladin_torch.ops.kernels import quant_matmul as qm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QSMALL = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, max_position_embeddings=64, img_feature_dim=20)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quant_inputs(rng, m, k, n):
    """x (M, K), w (K, N) as Flax holds it, bias (N,), and both packages'
    quantized operands (torch: wq (N, K))."""
    x = (rng.randn(m, k) * 0.4).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    jxq, jxs = jax_quantize_rowwise(jnp.asarray(x), axis=-1)
    jwq, jws = jax_quantize_rowwise(jnp.asarray(w), axis=0)
    return x, w, b, (jxq, jxs, jwq, jws)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rowwise_matches_jax(rng, dtype):
    x = (rng.randn(9, 48) * 2.0).astype(np.float32)
    x[3] = 0.0  # a zero row (padding) stays 0 with a finite scale
    jx = jnp.asarray(x).astype(dtype)
    jq, js = jax_quantize_rowwise(jx, axis=-1)
    q, s = quantize_rowwise(_t(jx.astype(jnp.float32)).to(getattr(torch, dtype)), dim=-1)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q[3] == 0).all() and torch.isfinite(s).all()
    # weights: Flax's kernel (K, N) over axis 0 == the nn.Linear weight (N, K) over K
    jwq, jws = jax_quantize_rowwise(jnp.asarray(x), axis=0)
    wq, ws = qm.quantize_weight(torch.from_numpy(x.T.copy()))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws).reshape(-1))


@pytest.mark.parametrize("activation", [None, "gelu", "gelu_tanh"])
@pytest.mark.parametrize("m", [96, 37])
def test_w8a8_matmul_plain_matches_pallas(rng, activation, m):
    _, _, b, (jxq, jxs, jwq, jws) = _quant_inputs(rng, m, 64, 128)
    want = jax_qm.w8a8_matmul(jxq, jxs, jwq, jws, jnp.asarray(b)[None], activation=activation,
                              block_m=64, block_n=128, out_dtype=jnp.float32, interpret=True)
    got = qm.w8a8_matmul(_t(jxq), _t(jxs), _t(jwq).T.contiguous(), _t(jws).reshape(-1), _t(b),
                         activation=activation, out_dtype=torch.float32)
    assert got.shape == (m, 128) and got.dtype == torch.float32
    if activation is None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", [None, "gelu"])
def test_w8a8_matmul_dynx_plain_matches_pallas(rng, activation):
    x, _, b, (_, _, jwq, jws) = _quant_inputs(rng, 70, 64, 128)
    want = jax_qm.w8a8_matmul_dynx(jnp.asarray(x), jwq, jws, jnp.asarray(b)[None],
                                   activation=activation, block_m=64, out_dtype=jnp.float32,
                                   interpret=True)
    got = qm.w8a8_matmul_dynx(_t(x), _t(jwq).T.contiguous(), _t(jws).reshape(-1), _t(b),
                              activation=activation, out_dtype=torch.float32)
    tol = 1e-6 if activation is None else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [48, 64])
def test_w8a8_quantize_then_matmul_is_dynx(rng, x_dtype, k):
    """K4-dynx as the port runs it on the card, the quantize pass and then
    K4 on its output: equal to the dynx plain version bitwise, and to
    aladin_tpu's ``_kernel_dynx`` in interpret mode within rtol 1e-6 (f32
    out, no activation: the same q and scales, exact int32 sums)."""
    x, _, b, (_, _, jwq, jws) = _quant_inputs(rng, 37, k, 96)
    jx = jnp.asarray(x).astype(x_dtype)
    xt = _t(jx.astype(jnp.float32)).to(getattr(torch, x_dtype))
    wq, ws = _t(jwq).T.contiguous(), _t(jws).reshape(-1)
    xq, xs = qm.w8a8_quantize(xt)
    assert xq.dtype == torch.int8 and xs.shape == (37, 1)
    got = qm.w8a8_matmul(xq, xs, wq, ws, _t(b), out_dtype=torch.float32)
    assert torch.equal(got, qm.w8a8_matmul_dynx(xt, wq, ws, _t(b), out_dtype=torch.float32))
    want = jax_qm.w8a8_matmul_dynx(jx, jwq, jws, jnp.asarray(b)[None], block_m=64,
                                   out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("activation", [None, "gelu", "gelu_tanh"])
def test_w8a8_apply_matches_jax(rng, activation):
    """Over (B, S, K) activations and Flax's f32 kernel, f32 out: the port's
    reciprocal-multiply scale against aladin_tpu's CPU division (rtol 1e-5)."""
    x, w, b, _ = _quant_inputs(rng, 30, 64, 96)
    x3 = x.reshape(3, 10, 64)
    want = jax_w8a8_apply(jnp.asarray(x3), jnp.asarray(w), jnp.asarray(b),
                          activation=activation, out_dtype=jnp.float32)
    got = w8a8_apply(_t(x3), torch.from_numpy(w.T.copy()), _t(b), activation=activation,
                     out_dtype=torch.float32)
    assert got.shape == (3, 10, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the pre-quantized entry on the same activations, quantized by division
    xq, xs = quantize_rowwise(_t(x3), dim=-1)
    got_xq = w8a8_apply_xq(xq, xs, torch.from_numpy(w.T.copy()), _t(b), activation=activation,
                           out_dtype=torch.float32)
    np.testing.assert_allclose(got_xq.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def _ln_inputs(rng, shape=(3, 7, 256)):
    d = shape[-1]
    return (rng.randn(*shape).astype(np.float32), (rng.randn(*shape) * 0.5).astype(np.float32),
            (1.0 + 0.1 * rng.randn(d)).astype(np.float32), (0.1 * rng.randn(d)).astype(np.float32))


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_residual_layernorm_q8_matches_jax(rng, impl, x_dtype):
    x, res, gamma, beta = _ln_inputs(rng)
    jx = jnp.asarray(x).astype(x_dtype)
    wy, wq, ws = jax_ln.residual_layernorm_q8(jx, jnp.asarray(res), jnp.asarray(gamma),
                                              jnp.asarray(beta), 1e-12, impl)
    tx = _t(jx.astype(jnp.float32)).to(getattr(torch, x_dtype))
    y, q, s = lk.residual_layernorm_q8(tx, _t(res), _t(gamma), _t(beta), 1e-12)
    assert (y.dtype, q.dtype, s.dtype) == (tx.dtype, torch.int8, torch.float32)
    assert y.shape == q.shape == x.shape and s.shape == (3, 7, 1)
    tol = 1e-2 if x_dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(y.float().numpy(), np.asarray(wy, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)
    assert np.abs(q.numpy().astype(int) - np.asarray(wq).astype(int)).max() <= 1


def test_residual_layernorm_q8_plain_is_quantized_y(rng):
    """(q, s) is quantize_rowwise of the f32 y, and y is K3a's y."""
    x, res, gamma, beta = (_t(a) for a in _ln_inputs(rng, (6, 64)))
    y, q, s = lk.residual_layernorm_q8_plain(x, res, gamma, beta)
    y3a = lk.residual_layernorm_forward_plain(x, res, gamma, beta)[0]
    assert torch.equal(y, y3a)
    wq, ws = quantize_rowwise(y, dim=-1)
    assert torch.equal(q, wq) and torch.equal(s, ws)


def test_layernorm_q8_matches_jax(rng):
    x = rng.randn(2, 5, 64).astype(np.float32)
    x[1, 2] = 0.0
    jq, js = jax_ln.layernorm_q8(jnp.asarray(x))
    q, s = lk.layernorm_q8(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s.shape == (2, 5, 1)


def test_quant_linear_state_dict_is_linear():
    ql, lin = QuantLinear(48, 32, "gelu"), torch.nn.Linear(48, 32)
    assert {k: v.shape for k, v in ql.state_dict().items()} == {
        k: v.shape for k, v in lin.state_dict().items()}
    ql.load_state_dict(lin.state_dict())  # and loads nn.Linear's
    assert torch.equal(ql.weight, lin.weight)


def test_quant_linear_tracks_f32(rng):
    """Per-row cosine of W8A8 against the f32 projection (as
    tests/test_quant.py::test_quant_dense_tracks_f32): > 0.999."""
    lin = torch.nn.Linear(48, 64)
    ql = QuantLinear(48, 64)
    ql.load_state_dict(lin.state_dict())
    x = torch.from_numpy((rng.randn(16, 48) * 3.0).astype(np.float32))
    with torch.no_grad():
        y32, y8 = lin(x), ql(x)
    cos = (y32 * y8).sum(-1) / (y32.norm(dim=-1) * y8.norm(dim=-1))
    assert cos.min().item() > 0.999


def _backbone_inputs(rng, b=3, l=10, r=6):
    ids = rng.randint(3, QSMALL["vocab_size"], (b, l)).astype(np.int32)
    typ = rng.randint(0, 2, (b, l)).astype(np.int32)
    txt_mask = (np.arange(l)[None] < rng.randint(4, l + 1, b)[:, None]).astype(np.int32)
    feats = rng.randn(b, r, QSMALL["img_feature_dim"]).astype(np.float32)
    img_mask = np.concatenate(
        [txt_mask, (np.arange(r)[None] < rng.randint(2, r + 1, b)[:, None]).astype(np.int32)],
        axis=1)
    return ids, typ, txt_mask, feats, img_mask


@pytest.mark.parametrize("knobs", [{"quant_matmuls": True},
                                   {"quant_matmuls": True, "fused_layernorm": True}],
                         ids=["quant", "quant_ln"])
def test_quant_backbone_matches_jax(rng, knobs):
    """Sequence output, pooler and hidden states on the text and image
    paths at f32, dropout 0: within 1e-3 of the largest output."""
    ids, typ, txt_mask, feats, img_mask = _backbone_inputs(rng)
    jmodel = JaxBertImgModel(JaxBertImgConfig(**QSMALL, **knobs))
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(img_mask),
                         jnp.asarray(typ), jnp.asarray(feats))["params"]
    model = BertImgModel(BertImgConfig(**QSMALL, **knobs)).eval()
    model.load_state_dict(bert_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    for img, mask in ((None, txt_mask), (feats, img_mask)):
        want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                            jnp.asarray(typ), None if img is None else jnp.asarray(img), True,
                            output_hidden_states=True)
        with torch.no_grad():
            got = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(typ),
                        None if img is None else torch.from_numpy(img),
                        output_hidden_states=True)
        for g, w in zip(got[:3], want[:3]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, atol=1e-3 * np.abs(w).max())


def test_weights_quantized_from_f32_after_cast_and_load(tmp_path):
    """build_model casts the serving model to bf16 and cli/test loads the
    checkpoint after that: the W8A8 layers keep f32 weights, take the
    checkpoint's values exactly, and quantize those (not bf16 roundings)."""
    cfg = load_config(os.path.join(ROOT, "aladin_torch", "configs",
                                   "alad-alignment-and-matching-distill.json"))
    args = DataArgs(synthetic=True, int8_encoder=True, img_feature_dim=32,
                    output_dir=str(tmp_path))
    model = build_model(cfg, args, torch.device("cpu"))
    attn = model.oscar_model.bert.encoder.layer[0].attention.self
    assert model.oscar_model.bert.pooler.dense.weight.dtype == torch.bfloat16
    assert attn.query.weight.dtype == torch.float32
    before = attn.qkv.quantized()[0].clone()

    gen = torch.Generator().manual_seed(7)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.05 if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    prefix = "oscar_model.bert.encoder.layer.0."
    w = torch.cat([sd[prefix + f"attention.self.{n}.weight"] for n in ("query", "key", "value")])
    assert torch.equal(attn.query.weight, sd[prefix + "attention.self.query.weight"])
    wq, ws, b = attn.qkv.quantized()
    want_q, want_s = quantize_rowwise(w, dim=1)
    assert torch.equal(wq, want_q) and torch.equal(ws, want_s.reshape(-1))
    assert not torch.equal(wq, before)  # the load invalidated the cache
    bf_q, bf_s = quantize_rowwise(w.bfloat16(), dim=1)
    assert not torch.equal(bf_s, want_s)  # quantizing after the cast would differ
    inter = model.oscar_model.bert.encoder.layer[0].intermediate.dense
    assert inter.weight.dtype == torch.float32 and inter.activation == cfg.model.hidden_act


def test_quant_encoder_preserves_retrieval_order():
    """tests/test_quant.py::test_quant_encoder_preserves_retrieval_order in
    the port: a 4-layer f32 encode against quant_matmuls with the same
    weights; mean-pooled cosine > 0.99 and top-1 neighbours agree for at
    least 11 of 12 rows."""
    cfg = dict(vocab_size=200, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
               intermediate_size=128, img_feature_dim=20, max_position_embeddings=64)
    b, l, r = 12, 10, 6
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    ids = np.asarray(jax.random.randint(ks[0], (b, l), 0, 200, jnp.int32))
    mask = np.ones((b, l + r), np.int32)
    feats = np.asarray(jax.random.normal(ks[1], (b, r, 20)))
    params = JaxBertImgModel(JaxBertImgConfig(**cfg)).init(
        ks[2], jnp.asarray(ids), jnp.asarray(mask), img_feats=jnp.asarray(feats))["params"]
    sd = bert_state_dict(jax.tree.map(np.asarray, params))
    outs = []
    for quant in (False, True):
        model = BertImgModel(dataclasses.replace(BertImgConfig(**cfg), quant_matmuls=quant)).eval()
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs.append(model(torch.from_numpy(ids), torch.from_numpy(mask),
                              img_feats=torch.from_numpy(feats))[0].numpy())
    emb32, emb8 = (o.mean(1) / np.linalg.norm(o.mean(1), axis=-1, keepdims=True) for o in outs)
    assert (emb32 * emb8).sum(-1).min() > 0.99
    s32, s8 = emb32 @ emb32.T, emb8 @ emb8.T
    np.fill_diagonal(s32, -np.inf)
    np.fill_diagonal(s8, -np.inf)
    assert (s32.argmax(1) == s8.argmax(1)).mean() >= 11 / 12


def test_dynx_scale_differs_from_division_by_at_most_an_ulp():
    """aladin_tpu's own documented difference, kept by the port: _kernel_dynx
    scales by max(absmax, 1e-8) * f32(1/127), quantize_rowwise divides by
    127. Over 10^6 log-normal absmax values the two scales differ in 1-10%
    of rows (about 4.5%), never by more than one f32 ulp."""
    absmax = np.exp(np.random.RandomState(0).randn(10 ** 6) * 3).astype(np.float32)
    x = torch.from_numpy(absmax)[:, None]
    s_div = quantize_rowwise(x, dim=-1)[1].numpy().ravel()
    s_mul = qm.quantize_rowwise_dynx(x)[1].numpy().ravel()
    share = float((s_div != s_mul).mean())
    assert 0.01 < share < 0.10, share
    ulps = np.abs(s_div.view(np.int32).astype(np.int64) - s_mul.view(np.int32))
    assert ulps.max() == 1
