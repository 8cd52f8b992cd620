"""The training kernels' plain versions against aladin_tpu's Pallas kernels
run in interpret mode, on the CPU, and the backbone with each knob on.

  * K2 (ops/kernels/attention_kernel.py) against
    ``fused_attention(..., interpret=True)``: forward and gradients at rate
    0 for 1-D (B, 1, S) and 2-D (B, S, S) biases, rtol/atol 1e-5 forward and
    2e-4 for the gradients (the same f32 math summed in another order;
    observed ~1e-6). With dropout the masks differ by design (the TPU PRNG
    has no counterpart), so the port is held to its own contract: the same
    seed gives the same output, another seed another one, the keep rate is
    within 0.01 of 1 - rate, and the backward uses the forward's mask (a
    central finite difference along a random direction agrees with the
    gradient, as tests/test_attention_kernel.py checks it in JAX).
  * K3a (ops/kernels/layernorm.py) against
    ``residual_layernorm(..., impl="interpret")``: forward and VJP
    (dx, dres, dgamma, dbeta), in f32 (atol 2e-5) and with bf16 x / f32 res
    (the bf16 output within one bf16 rounding, 1e-2; dx cast to bf16 the
    same way).
  * BertImgModel with fused_attention / fused_layernorm against
    aladin_tpu's with the same knob, dropout 0, atol 1e-4 (f32 math in
    another order, as tests/test_torch_models.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.models.bert_img import BertImgConfig as JaxBertImgConfig
from aladin_tpu.models.bert_img import BertImgModel as JaxBertImgModel
from aladin_tpu.ops.pallas.attention_kernel import fused_attention as jax_fused_attention
from aladin_tpu.ops.pallas.layernorm import residual_layernorm as jax_residual_layernorm
from aladin_torch.io.convert import bert_state_dict
from aladin_torch.models.bert_img import BertImgConfig, BertImgModel
from aladin_torch.ops.kernels import attention_kernel as ak
from aladin_torch.ops.kernels import layernorm as lk
from tests.test_models import SMALL

B, S, H, D = 3, 20, 4, 8


def _qkv(rng, q_dim):
    q, k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(3))
    mask = (rng.rand(B, q_dim, S) > 0.2).astype(np.float32)
    mask[0] = 0.0  # a row that is all padding stays finite (-10000, not -inf)
    bias = (1.0 - mask) * -10000.0
    return q, k, v, bias


@pytest.mark.parametrize("q_dim", [1, S])
def test_attention_forward_matches_pallas(rng, q_dim):
    q, k, v, bias = _qkv(rng, q_dim)
    want = jax_fused_attention(*(jnp.asarray(a) for a in (q, k, v, bias)), interpret=True)
    got = ak.fused_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q_dim", [1, S])
def test_attention_gradients_match_pallas(rng, q_dim):
    q, k, v, bias = _qkv(rng, q_dim)
    w = rng.randn(B, S, H, D).astype(np.float32)

    def jloss(a, b, c):
        return jnp.sum(jax_fused_attention(a, b, c, jnp.asarray(bias), interpret=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_()
    (ak.fused_attention(tq, tk, tv, tb) * torch.from_numpy(w)).sum().backward()
    for got, wg in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(wg), rtol=2e-4, atol=2e-4)
    assert tb.grad is None  # bias gets no gradient


def test_attention_dropout_is_reproducible(rng):
    args = [torch.from_numpy(a) for a in _qkv(rng, 1)]
    out1 = ak.fused_attention(*args, 7, 0.5, True)
    out2 = ak.fused_attention(*args, 7, 0.5, True)
    out3 = ak.fused_attention(*args, 8, 0.5, True)
    base = ak.fused_attention(*args)
    assert torch.equal(out1, out2)
    assert not torch.allclose(out1, out3)
    assert 0.5 < float(out1.abs().mean() / base.abs().mean()) < 2.0
    assert torch.equal(ak.fused_attention(*args, 7, 0.5, False), base)  # eval: no dropout


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_mask_rate_and_independence(rate):
    keep = ak.keep_mask(1234, 16, 12, 50, rate)
    assert abs(keep.float().mean().item() - (1.0 - rate)) < 0.01
    other = ak.keep_mask(1235, 16, 12, 50, rate)
    agree = (keep == other).float().mean().item()
    expect = (1 - rate) ** 2 + rate ** 2  # two independent masks agree this often
    assert abs(agree - expect) < 0.01


def test_keep_mask_hash_is_exact_uint32():
    """The plain version's 16-bit split multiply equals uint32 arithmetic."""
    xs = np.random.RandomState(1).randint(0, 2 ** 32, 1000, dtype=np.uint64)
    got = ak._mix32(torch.from_numpy(xs.astype(np.int64))).numpy().astype(np.uint64)
    x = xs.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
    np.testing.assert_array_equal(got, x.astype(np.uint64))


def test_attention_dropout_backward_uses_the_forward_mask(rng):
    """<grad, probe> against a central difference along the probe, for v
    (the loss is linear in v) and q (through the undropped softmax), in
    f64 (the plain version accumulates in f64 for f64 inputs): rtol 1e-6."""
    q, k, v, bias = (torch.from_numpy(a).double() for a in _qkv(rng, S))
    w = torch.from_numpy(np.random.RandomState(3).randn(B, S, H, D))
    probe = torch.from_numpy(np.random.RandomState(4).randn(B, S, H, D))
    rate, seed, eps = 0.3, 11, 1e-5

    def loss(q_, v_):
        return (ak.fused_attention(q_, k, v_, bias, seed, rate, True) * w).sum()

    qq, vv = q.clone().requires_grad_(), v.clone().requires_grad_()
    loss(qq, vv).backward()
    for grad, shifted in ((vv.grad, lambda e: loss(q, v + e * probe)),
                          (qq.grad, lambda e: loss(q + e * probe, v))):
        fd = (shifted(eps) - shifted(-eps)) / (2 * eps)
        np.testing.assert_allclose(float((grad * probe).sum()), float(fd), rtol=1e-6)


def _ln_inputs(rng, shape=(3, 7, 256)):
    d = shape[-1]
    return (rng.randn(*shape).astype(np.float32), (rng.randn(*shape) * 0.5).astype(np.float32),
            (1.0 + 0.1 * rng.randn(d)).astype(np.float32), (0.1 * rng.randn(d)).astype(np.float32))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_residual_layernorm_matches_pallas(rng, x_dtype):
    x, res, gamma, beta = _ln_inputs(rng)
    gy = rng.randn(*x.shape).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    want_y, vjp = jax.vjp(lambda a, b, c, d: jax_residual_layernorm(a, b, c, d, 1e-12,
                                                                    "interpret"),
                          jx, jnp.asarray(res), jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(gy).astype(want_y.dtype))

    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32)).copy()).to(getattr(torch, x_dtype))
    tx.requires_grad_()
    tr, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (res, gamma, beta))
    y = lk.residual_layernorm(tx, tr, tg, tb, 1e-12)
    assert y.dtype == tx.dtype
    y.backward(torch.from_numpy(gy).to(y.dtype))
    tol = 1e-2 if x_dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(want_y, np.float32),
                               atol=tol, rtol=tol)
    for got, w in zip((tx.grad, tr.grad, tg.grad, tb.grad), want):
        assert got.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32),
                                   atol=tol * 10 if w.ndim == 1 else tol, rtol=tol)


def test_residual_layernorm_stats_and_plain_autograd(rng):
    """Saved statistics are the fast-variance form in f32; the analytic
    backward equals autograd through the plain version (the same f32 math
    in another order: rtol 1e-5, atol 1e-6)."""
    x, res, gamma, beta = (torch.from_numpy(a) for a in _ln_inputs(rng, (5, 64)))
    y, mean, rstd = lk.residual_layernorm_forward(x, res, gamma, beta, 1e-12)
    h = (x + res).double()
    np.testing.assert_allclose(mean.squeeze(1).numpy(), h.mean(1).numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rstd.squeeze(1).numpy(), (1 / h.std(1, unbiased=False)).numpy(),
                               rtol=1e-5)
    gy = torch.from_numpy(rng.randn(5, 64).astype(np.float32))
    grads = []
    for fn in (lk.residual_layernorm, lk.residual_layernorm_plain):
        args = [t.clone().requires_grad_() for t in (x, res, gamma, beta)]
        fn(*args, 1e-12).backward(gy)
        grads.append([a.grad for a in args])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def _backbone_inputs(rng, b=3, l=10, r=6):
    ids = rng.randint(3, SMALL["vocab_size"], (b, l)).astype(np.int32)
    typ = rng.randint(0, 2, (b, l)).astype(np.int32)
    txt_mask = (np.arange(l)[None] < rng.randint(4, l + 1, b)[:, None]).astype(np.int32)
    feats = rng.randn(b, r, SMALL["img_feature_dim"]).astype(np.float32)
    img_mask = np.concatenate(
        [txt_mask, (np.arange(r)[None] < rng.randint(2, r + 1, b)[:, None]).astype(np.int32)],
        axis=1)
    return ids, typ, txt_mask, feats, img_mask


@pytest.mark.parametrize("knob", ["fused_attention", "fused_layernorm"])
def test_backbone_with_kernel_knob_matches_jax(rng, knob):
    """Sequence output, pooler and hidden states on both paths, and the
    gradient of a scalar of the output w.r.t. every parameter."""
    ids, typ, txt_mask, feats, img_mask = _backbone_inputs(rng)
    jcfg = JaxBertImgConfig(**SMALL, **{knob: True})
    jmodel = JaxBertImgModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(img_mask),
                         jnp.asarray(typ), jnp.asarray(feats))["params"]
    model = BertImgModel(BertImgConfig(**SMALL, **{knob: True})).eval()
    model.load_state_dict(bert_state_dict(jax.tree.map(np.asarray, params)), strict=True)
    for img, mask in ((None, txt_mask), (feats, img_mask)):
        want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                            jnp.asarray(typ), None if img is None else jnp.asarray(img), True,
                            output_hidden_states=True)
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(typ),
                    None if img is None else torch.from_numpy(img), output_hidden_states=True)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4)

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(ids), jnp.asarray(img_mask),
                           jnp.asarray(typ), jnp.asarray(feats), True)
        return jnp.sum(jnp.sin(out[0]))

    jgrads = bert_state_dict(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    torch.sin(model(torch.from_numpy(ids), torch.from_numpy(img_mask), torch.from_numpy(typ),
                    torch.from_numpy(feats))[0]).sum().backward()
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad  # the pooler takes none
        np.testing.assert_allclose(got.numpy(), jgrads[name].numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)


def test_fused_attention_refuses_output_attentions(rng):
    ids, typ, txt_mask, _, _ = _backbone_inputs(rng)
    model = BertImgModel(BertImgConfig(**SMALL, fused_attention=True))
    with pytest.raises(ValueError, match="output_attentions"):
        model(torch.from_numpy(ids), torch.from_numpy(txt_mask), torch.from_numpy(typ),
              output_attentions=True)


def test_fused_attention_draws_a_seed_per_layer_call(rng):
    """In training with dropout each layer call takes a fresh seed from the
    model's CPU generator, so two calls differ; in eval none is drawn."""
    ids, typ, txt_mask, _, _ = _backbone_inputs(rng)
    model = BertImgModel(BertImgConfig(**SMALL, fused_attention=True, hidden_dropout_prob=0.0))
    args = [torch.from_numpy(a) for a in (ids, txt_mask, typ)]
    state = model.seed_generator.get_state()
    model.eval()
    a, b = model(*args)[0], model(*args)[0]
    assert torch.equal(a, b) and torch.equal(model.seed_generator.get_state(), state)
    model.train()
    c, d = model(*args)[0], model(*args)[0]
    assert not torch.allclose(c, d)
