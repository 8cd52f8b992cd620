"""The memory levers on the CPU: per-layer remat (``BertImgConfig.remat``)
and encoder micro-batches (``training.encoder-microbatch``), against
aladin_tpu and against the port without them.

  * remat against aladin_tpu's ``nn.remat`` backbone, with the kernel knobs
    off and on (their plain versions here, the Pallas kernels in interpret
    mode there): one train step's loss terms, gradients and post-Adam
    params, to ``tests/test_torch_train.py``'s tolerances (rtol 1e-4 on
    losses, atol 1e-5 of the largest gradient + rtol 1e-4 on gradients,
    atol 1e-6 on params where the gradient is live);
  * remat against no remat in the port: bit for bit, at dropout 0 and 0.1
    (the K2 seeds are drawn outside the checkpointed layers, and
    checkpoint restores the generator for the plain dropouts);
  * micro-batches of 2 at B 8 against aladin_tpu's encode_microbatched and
    against the unsplit port at dropout 0, to the same tolerances; a batch
    the micro-batch does not divide raises; B <= mb runs unsplit;
  * a window of K 2 (``make_multi_train_step``) with each lever equals two
    single steps bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.config import ExperimentConfig as JaxExperimentConfig
from aladin_tpu.models.aladin import ALADIN as JaxALADIN
from aladin_tpu.train.state import create_train_state
from aladin_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aladin_tpu.train.step import make_train_step as jax_make_train_step
from aladin_torch.config import ExperimentConfig
from aladin_torch.io.convert import aux_from_flax, params_from_flax, state_dict_from_flax
from aladin_torch.models.aladin import ALADIN
from aladin_torch.models.bert_img import BertImgConfig
from aladin_torch.train.state import TrainState
from aladin_torch.train.step import (encode_microbatched, make_loss_fn, make_multi_train_step,
                                     make_train_step)
from tests.test_models import SMALL, make_batch, small_cfg
from tests.test_torch_models import _np_tree, _torch_batch
from tests.test_torch_threads import _two_threads  # noqa: F401 (autouse)

LR = 1e-3
KNOBS = {"off": {}, "on": {"fused_attention": True, "fused_layernorm": True}}


def _recipe(mb=0, dropout=0.0, loss="alignment-distillation-matching",
            weights=(1, 1, 0.5)):
    return {"model": {"embed-size": SMALL["hidden_size"], "tern-layers": 1, "dropout": dropout},
            "training": {"loss-type": loss, "loss-weights": list(weights), "lr": LR, "bs": 8,
                         "grad-clip": 2.0, "encoder-microbatch": mb}}


def _bert(dropout=0.0, **knobs):
    return dict(SMALL, hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout,
                **knobs)


def _port(d, bert, seed=0, state_dict=None):
    model = ALADIN(ExperimentConfig.from_dict(d), BertImgConfig(**bert))
    if state_dict is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    return TrainState(ExperimentConfig.from_dict(d), model, steps_per_epoch=10)


def _jax_and_port(d, bert, rng, b=4):
    """(jax model, jax cfg, jax state, port state, jax batch) from one
    seeded Flax init."""
    jcfg = JaxExperimentConfig.from_dict(d)
    jmodel = JaxALADIN(jcfg, small_cfg(**{k: v for k, v in bert.items() if k not in SMALL}))
    jbatch = make_batch(rng, b=b)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, True)["params"]
    jstate = create_train_state(jcfg, params, steps_per_epoch=10)
    state = _port(d, bert, state_dict=state_dict_from_flax(_np_tree(params)))
    with torch.no_grad():
        for k, v in aux_from_flax(_np_tree(jstate.params["aux"])).items():
            state.aux[k].copy_(v)
    return jmodel, jcfg, jstate, state, jbatch


def _assert_step_matches_jax(jmodel, jcfg, jstate, state, jbatch):
    """One train step: loss terms and every gradient, then grad_norm and
    the params after clip + Adam."""
    batch = _torch_batch(jbatch)
    (_, jm), jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel, jcfg), has_aux=True))(
        jstate.params, jbatch, jnp.int32(0), jax.random.PRNGKey(1))
    state.model.train()
    total, metrics = make_loss_fn(state.model, state.cfg)(state.aux, batch, 0)
    total.backward()
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-4, err_msg=k)
    grads = params_from_flax(_np_tree(jgrads))
    got = state.named_params()
    assert set(grads) == set(got)
    scale = max(float(np.abs(g.numpy()).max()) for g in grads.values())
    for name, w in grads.items():
        g = torch.zeros_like(got[name]) if got[name].grad is None else got[name].grad
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)

    before = params_from_flax(_np_tree(jstate.params))
    new_jstate, jm = jax_make_train_step(jmodel, jcfg)(jstate, jbatch, jnp.int32(0),
                                                       jax.random.PRNGKey(1))
    metrics = make_train_step(state.model, state.cfg)(state, batch, 0)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-4)
    want = params_from_flax(_np_tree(new_jstate.params))
    for name, p in state.named_params().items():
        got_p, w = p.detach().numpy(), want[name].numpy()
        live = np.abs(grads[name].numpy()) > 1e-4 * scale
        np.testing.assert_allclose(got_p[live], w[live], atol=1e-6, err_msg=name)
        assert np.all(np.abs(got_p - before[name].numpy()) <= LR * 1.001), name


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_remat_step_matches_jax(rng, knobs):
    _assert_step_matches_jax(*_jax_and_port(_recipe(), _bert(remat=True, **KNOBS[knobs]), rng))


def test_encoder_microbatch_step_matches_jax(rng):
    """encoder-microbatch 2 at B 8, as tests/test_train.py runs
    aladin_tpu's encode_microbatched."""
    _assert_step_matches_jax(*_jax_and_port(_recipe(mb=2), _bert(), rng, b=8))


def _one_step(d, bert, batch, seed=0):
    """(metrics, the trainable params after one step) from seeded weights,
    every generator reseeded first."""
    state = _port(d, bert, seed=seed)
    torch.manual_seed(11)
    state.model.oscar_model.bert.seed_generator.manual_seed(11)
    metrics = make_train_step(state.model, state.cfg)(state, batch, 0)
    return metrics, [p.detach().clone() for p in state.trainable]


def _assert_bitwise(a, b):
    assert set(a[0]) == set(b[0])
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_remat_equals_no_remat_bitwise(rng, knobs, dropout):
    batch = _torch_batch(make_batch(rng, b=8))
    d = _recipe(dropout=dropout)
    plain = _one_step(d, _bert(dropout, **KNOBS[knobs]), batch)
    remat = _one_step(d, _bert(dropout, remat=True, **KNOBS[knobs]), batch)
    _assert_bitwise(plain, remat)


def test_remat_recomputes_each_layer_once(rng, monkeypatch):
    """Under remat a layer's forward runs twice a step (forward and
    recompute), its backward once; without remat once each; under eval or
    no_grad remat does nothing."""
    from aladin_torch.models import bert_img

    calls = {"fwd": 0}
    forward = bert_img.BertLayer.forward

    def counted(self, *args):
        calls["fwd"] += 1
        return forward(self, *args)

    monkeypatch.setattr(bert_img.BertLayer, "forward", counted)
    batch = _torch_batch(make_batch(rng, b=8))
    layers = 2 * SMALL["num_hidden_layers"]  # two passes
    for remat, want in ((False, layers), (True, 2 * layers)):
        calls["fwd"] = 0
        _one_step(_recipe(), _bert(remat=remat), batch)
        assert calls["fwd"] == want, remat
    state = _port(_recipe(), _bert(remat=True))
    calls["fwd"] = 0
    with torch.no_grad():
        state.model.train()(batch)
    state.model.eval()(batch).img_global.sum()
    assert calls["fwd"] == 2 * layers


@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_microbatch_matches_unsplit(rng, knobs):
    """At dropout 0, micro-batches of 2 against the unsplit step (GEMMs at
    another M): losses and grad_norm, the (clipped) gradients, and the
    params after Adam, to the train tolerances."""
    batch = _torch_batch(make_batch(rng, b=8))
    runs = []
    for mb in (0, 2):
        state = _port(_recipe(mb=mb), _bert(**KNOBS[knobs]))
        metrics = make_train_step(state.model, state.cfg)(state, batch, 0)
        runs.append((metrics, {n: (p.detach().clone(), torch.zeros_like(p) if p.grad is None
                                   else p.grad.clone())  # the pooler takes none
                               for n, p in state.named_params().items()}))
    (whole, want), (split, got) = runs
    for k, v in whole.items():
        np.testing.assert_allclose(split[k].item(), v.item(), rtol=1e-4, err_msg=k)
    scale = max(float(g.abs().max()) for _, g in want.values())
    for name, (p, g) in want.items():
        np.testing.assert_allclose(got[name][1].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
        live = (g.abs() > 1e-4 * scale).numpy()
        diff = (got[name][0] - p).abs().numpy()
        assert np.all(diff[live] <= 1e-6) and np.all(diff <= 2 * LR * 1.001), name


def test_microbatch_outputs_and_l1_reg(rng):
    """The concatenated outputs equal the unsplit forward's, and l1_reg is
    the mean of the micro-batches' values."""
    batch = _torch_batch(make_batch(rng, b=8))
    d = _recipe(mb=2, loss="alignment-regularizehidden", weights=(1, 1))
    state = _port(d, _bert())
    model = state.model.train()
    whole = model(batch)
    split = encode_microbatched(model, batch, 2)
    for f in dataclasses.fields(whole):
        np.testing.assert_allclose(getattr(split, f.name).detach().numpy(),
                                   getattr(whole, f.name).detach().numpy(), atol=1e-5,
                                   err_msg=f.name)
    rows = [model(type(batch)(**{f: getattr(batch, f)[i:i + 2]
                                 for f in batch.__dataclass_fields__})).l1_reg
            for i in range(0, 8, 2)]
    np.testing.assert_allclose(split.l1_reg.item(), torch.stack(rows).mean().item(), rtol=1e-6)


def test_microbatch_must_divide_the_batch(rng):
    batch = _torch_batch(make_batch(rng, b=8))
    state = _port(_recipe(mb=3), _bert())
    with pytest.raises(ValueError, match="does not divide"):
        make_loss_fn(state.model, state.cfg)(state.aux, batch, 0)


def test_microbatch_not_below_the_batch_runs_unsplit(rng):
    """B <= mb: the unsplit forward, bit for bit (no checkpoint at all)."""
    batch = _torch_batch(make_batch(rng, b=8))
    _assert_bitwise(_one_step(_recipe(mb=8), _bert(0.1), batch),
                    _one_step(_recipe(), _bert(0.1), batch))


@pytest.mark.parametrize("lever", ["remat", "microbatch", "both"])
def test_window_with_a_lever_equals_single_steps(lever):
    """K 2 as one window (on the CPU, two eager steps) against two single
    steps, dropout 0.1 and both kernel knobs: bit for bit."""
    batches = [_torch_batch(make_batch(np.random.RandomState(s), b=8)) for s in range(2)]
    d = _recipe(mb=0 if lever == "remat" else 2, dropout=0.1)
    bert = _bert(0.1, remat=lever != "microbatch", **KNOBS["on"])
    a, b = _port(d, bert), _port(d, bert)
    for s in (a, b):
        s.model.oscar_model.bert.seed_generator.manual_seed(5)
    torch.manual_seed(5)
    step = make_train_step(a.model, a.cfg)
    singles = [step(a, x, 0) for x in batches]
    torch.manual_seed(5)
    window = make_multi_train_step(b.model, b.cfg, k=2)(b, batches, 0)
    for name, v in window.items():
        assert torch.equal(v, torch.stack([m[name] for m in singles])), name
    for p, q in zip(a.trainable, b.trainable):
        assert torch.equal(p, q)
