"""The port's model variants against aladin_tpu on the CPU: depth
aggregation on either side (None, mean, gated, transformer), the feature
fusion, the post-OSCAR encoder, the TERAN stacks (shared and separate),
the L1 hidden regulariser with aggregation, one train step of a variant,
the freeze-teran split, the pooling aggregators, the positional encodings,
the attention-aggregation modules, and a variant ``.pth.tar`` written by
aladin_tpu.

Same seeded Flax parameters (carried across by ``state_dict_from_flax`` or
the key maps below) and numpy inputs, f32, dropout off. Tolerances: atol
1e-4 on forwards (the same f32 math summed in another order), and the
train step's of ``tests/test_torch_train.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.config import ExperimentConfig as JaxExperimentConfig
from aladin_tpu.io.convert import save_aladin_checkpoint as jax_save_aladin
from aladin_tpu.models import attention_aggregation as jagg
from aladin_tpu.models import layers as jlayers
from aladin_tpu.models.aladin import ALADIN as JaxALADIN
from aladin_tpu.train.state import create_train_state
from aladin_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aladin_tpu.train.step import make_train_step as jax_make_train_step
from aladin_torch.config import ExperimentConfig
from aladin_torch.io.convert import (aux_from_flax, load_aladin_checkpoint, params_from_flax,
                                     state_dict_from_flax)
from aladin_torch.models import attention_aggregation as agg
from aladin_torch.models import layers
from aladin_torch.models.aladin import ALADIN
from aladin_torch.models.bert_img import BertImgConfig
from aladin_torch.train.state import TrainState
from aladin_torch.train.step import make_loss_fn, make_train_step
from tests.test_models import SMALL, make_batch, small_cfg
from tests.test_torch_models import _compare_outputs, _np_tree, _torch_batch
from tests.test_torch_threads import _two_threads  # noqa: F401 (autouse)

ATOL = 1e-4
LR = 1e-3
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)

VARIANTS = {
    "none": {},
    "align_mean": {"depth-aggregation-alignment": "mean"},
    "align_gated": {"depth-aggregation-alignment": "gated"},
    "align_transformer": {"depth-aggregation-alignment": "transformer"},
    "match_mean": {"depth-aggregation-matching": "mean"},
    "match_gated": {"depth-aggregation-matching": "gated"},
    "match_transformer": {"depth-aggregation-matching": "transformer"},
    "match_mean_post1": {"depth-aggregation-matching": "mean", "post-layers": 1},
    "match_transformer_post1": {"depth-aggregation-matching": "transformer", "post-layers": 1},
    "both_gated_post1": {"depth-aggregation-alignment": "gated",
                         "depth-aggregation-matching": "gated", "post-layers": 1},
    "teran_shared": {"teran-layers": 2},
    "teran_separate": {"teran-layers": 2, "shared-transformer": False},
    "teran_with_aggregation": {"teran-layers": 1, "shared-transformer": False,
                               "depth-aggregation-alignment": "gated",
                               "depth-aggregation-matching": "mean"},
}


def _recipe(model_over, loss_type="alignment-distillation"):
    return {"model": {"embed-size": SMALL["hidden_size"], "tern-layers": 1, "dropout": 0.0,
                      **model_over},
            "training": {"loss-type": loss_type, "loss-weights": [1, 1], "lr": LR, "bs": 4,
                         "grad-clip": 2.0}}


def _both(d, rng):
    """(jax model, jax params, port model, jax batch) from one recipe."""
    jmodel = JaxALADIN(JaxExperimentConfig.from_dict(d), small_cfg(**NO_DROPOUT))
    jbatch = make_batch(rng)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, True)["params"]
    model = ALADIN(ExperimentConfig.from_dict(d), BertImgConfig(**SMALL, **NO_DROPOUT))
    model.load_state_dict(state_dict_from_flax(_np_tree(params)), strict=True)
    return jmodel, params, model, jbatch


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_forward_matches(rng, variant):
    """Every output of the forward, the module set strict in both
    directions (no port tensor left without a Flax counterpart)."""
    jmodel, params, model, jbatch = _both(_recipe(VARIANTS[variant]), rng)
    want = jmodel.apply({"params": params}, jbatch, True)
    with torch.no_grad():
        _compare_outputs(model.eval()(_torch_batch(jbatch)), want)


@pytest.mark.parametrize("variant", ["align_gated", "match_mean_post1"])
def test_regularizehidden_with_aggregation(rng, variant):
    jmodel, params, model, jbatch = _both(
        _recipe(VARIANTS[variant], "alignment-regularizehidden"), rng)
    want = jmodel.apply({"params": params}, jbatch, True)
    with torch.no_grad():
        got = model.eval()(_torch_batch(jbatch))
    assert float(want.l1_reg) > 0
    _compare_outputs(got, want)


def test_module_names_follow_the_reference():
    """The names FROZEN_WITH_TERAN and aladin_tpu's .pth.tar maps expect."""
    d = _recipe({"teran-layers": 1, "shared-transformer": False, "post-layers": 1,
                 "depth-aggregation-alignment": "gated",
                 "depth-aggregation-matching": "transformer"})
    model = ALADIN(ExperimentConfig.from_dict(d), BertImgConfig(**SMALL))
    tops = {name for name, _ in model.named_children()}
    assert tops == {"oscar_model", "depth_aggregator_model_alignment", "feature_fusion",
                    "post_oscar_transformer", "depth_aggregator_model_matching",
                    "transformer_encoder_1", "transformer_encoder_2", "final_projection_net"}
    keys = set(model.state_dict())
    for k in ("depth_aggregator_model_alignment.self_attn.in_proj_weight",
              "depth_aggregator_model_alignment.self_attn.out_proj.bias",
              "depth_aggregator_model_alignment.gate_ffn.weight",
              "feature_fusion.alphas.0.weight", "feature_fusion.alphas.3.bias",
              "depth_aggregator_model_matching.depth_transformer.layers.0.linear1.weight"):
        assert k in keys, k


CASES = {
    "gated_separate": {"depth-aggregation-alignment": "gated", "teran-layers": 1,
                       "shared-transformer": False},
    "gated_separate_frozen": {"depth-aggregation-alignment": "gated", "teran-layers": 1,
                              "shared-transformer": False, "freeze-teran": True},
}


class _Deterministic:
    """aladin_tpu's model with its dropout off in the train step: the
    variant modules' own rates (0.1 in the gated self-attention, the
    feature fusion and the depth transformer) are fixed, as in the
    reference, and two packages' draws cannot agree."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, batch, deterministic, rngs=None):
        return self.model.apply(variables, batch, True)


def _states(case, rng):
    d = _recipe(CASES[case])
    jmodel, params, model, jbatch = _both(d, rng)
    jmodel = _Deterministic(jmodel)
    for m in model.modules():  # the port's fixed rates, likewise
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    jcfg = JaxExperimentConfig.from_dict(d)
    jstate = create_train_state(jcfg, params, steps_per_epoch=10)
    state = TrainState(ExperimentConfig.from_dict(d), model, steps_per_epoch=10)
    with torch.no_grad():
        for k, v in aux_from_flax(_np_tree(jstate.params["aux"])).items():
            state.aux[k].copy_(v)
    return jmodel, jcfg, jstate, state, jbatch


@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_train_step_matches(rng, case):
    """One step of gated alignment-side aggregation with separate TERAN
    stacks: loss terms, every gradient by name, grad_norm and the params
    after clip + Adam, to test_torch_train.py's tolerances."""
    jmodel, jcfg, jstate, state, jbatch = _states(case, rng)
    batch = _torch_batch(jbatch)
    (_, jm), jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel, jcfg), has_aux=True))(
        jstate.params, jbatch, jnp.int32(0), jax.random.PRNGKey(1))
    state.model.train()
    total, metrics = make_loss_fn(state.model, state.cfg)(state.aux, batch, 0)
    total.backward()
    for k, v in jm.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-4, err_msg=k)
    grads = params_from_flax(_np_tree(jgrads))
    got = state.named_params()
    assert set(grads) == set(got)
    scale = max(float(np.abs(g.numpy()).max()) for g in grads.values())
    for name, w in grads.items():
        g = got[name].grad
        g = torch.zeros_like(got[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)

    before = params_from_flax(_np_tree(jstate.params))
    new_jstate, jm = jax_make_train_step(jmodel, jcfg)(jstate, jbatch, jnp.int32(0),
                                                       jax.random.PRNGKey(1))
    for p in state.parameters():
        p.grad = None
    metrics = make_train_step(state.model, state.cfg)(state, batch, 0)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    want = params_from_flax(_np_tree(new_jstate.params))
    for name, p in state.named_params().items():
        got_p, w = p.detach().numpy(), want[name].numpy()
        live = np.abs(grads[name].numpy()) > 1e-4 * scale
        np.testing.assert_allclose(got_p[live], w[live], atol=1e-6, err_msg=name)
        assert np.all(np.abs(got_p - before[name].numpy()) <= LR * 1.001), name


def test_freeze_teran_split_matches_jax(rng):
    """teran-layers 2 (separate), freeze-teran, alignment-side aggregation:
    the port's frozen parameters are exactly those optax's multi_transform
    labels frozen in aladin_tpu, and after a step they have not moved."""
    d = _recipe({"teran-layers": 2, "shared-transformer": False, "freeze-teran": True,
                 "depth-aggregation-alignment": "gated",
                 "depth-aggregation-matching": "mean"})
    from aladin_tpu.train.state import FROZEN_WITH_TERAN as JAX_FROZEN

    jmodel, params, model, jbatch = _both(d, rng)
    labels = {"model": {top: jax.tree.map(
        lambda v, f=top in JAX_FROZEN: np.full(np.shape(v), float(f), np.float32), sub)
        for top, sub in params.items()}}
    want = {name for name, v in params_from_flax(labels).items() if v.min() == 1.0}
    assert {name for name, v in params_from_flax(labels).items() if v.max() == 1.0} == want
    state = TrainState(ExperimentConfig.from_dict(d), model, steps_per_epoch=10)
    names = {id(p): n for n, p in model.named_parameters()}
    frozen = {names[id(p)] for p in state.frozen}
    assert frozen == want
    assert {n.split(".")[0] for n in frozen} == {
        "oscar_model", "transformer_encoder_1", "transformer_encoder_2",
        "depth_aggregator_model_alignment", "feature_fusion"}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    make_train_step(model, state.cfg)(state, _torch_batch(jbatch), 0)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == (n in frozen), n


def test_variant_pth_tar_written_by_aladin_tpu_loads(rng, tmp_path):
    """aladin_tpu's save_aladin_checkpoint of a variant (gated aggregation
    on both sides, feature fusion, post-OSCAR encoder, separate TERAN
    stacks) loads into the port by prefix removal alone, strict, with the
    same tensors as state_dict_from_flax, and the forwards agree."""
    d = _recipe(VARIANTS["both_gated_post1"] | {"teran-layers": 1, "shared-transformer": False})
    jmodel, params, model, jbatch = _both(d, rng)
    path = jax_save_aladin(str(tmp_path / "variant.pth.tar"), _np_tree(params), d)
    sd, cfg, _ = load_aladin_checkpoint(path)
    fresh = ALADIN(ExperimentConfig.from_dict(cfg), BertImgConfig(**SMALL)).eval()
    fresh.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    want = jmodel.apply({"params": params}, jbatch, True)
    with torch.no_grad():
        _compare_outputs(fresh(_torch_batch(jbatch)), want)


# --- the head-side building blocks against their Flax modules ------------

def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _load(module, params, rename):
    """Flax params -> ``module`` by ``rename`` (Flax path prefix -> torch
    prefix): Dense kernels transposed, LayerNorm scales as weights."""
    sd = {}
    for path, v in _flat(params).items():
        for src, dst in rename.items():
            if path[:len(src)] == src:
                leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
                mid = path[len(src):-1]
                key = ".".join((dst,) + mid + (leaf,)) if dst else ".".join(mid + (leaf,))
                sd[key] = torch.from_numpy(v.T.copy() if path[-1] == "kernel" else v.copy())
                break
        else:
            raise KeyError(path)
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _gru_params(cell):
    """Flax GRUCell (ir/iz/in with biases, hr/hz without, hn with) ->
    nn.GRU's packed weight_ih / weight_hh (r, z, n) and biases."""
    ih = [cell[g]["kernel"].T for g in ("ir", "iz", "in")]
    hh = [cell[g]["kernel"].T for g in ("hr", "hz", "hn")]
    zero = np.zeros_like(cell["hn"]["bias"])
    return {"gru_aggr.weight_ih_l0": np.concatenate(ih),
            "gru_aggr.weight_hh_l0": np.concatenate(hh),
            "gru_aggr.bias_ih_l0": np.concatenate([cell[g]["bias"] for g in ("ir", "iz", "in")]),
            "gru_aggr.bias_hh_l0": np.concatenate([zero, zero, cell["hn"]["bias"]])}


def _tokens(rng, b=3, s=7, d=32):
    x = rng.randn(b, s, d).astype(np.float32)
    lengths = np.array([7, 3, 1][:b], np.int32)
    return x, lengths, np.arange(s)[None] >= lengths[:, None]


@pytest.mark.parametrize("mode", ["first", "sum", "sum-and-map", "gated", "gru"])
def test_aggregator_matches_flax(rng, mode):
    x, lengths, pad = _tokens(rng)
    jm = jlayers.Aggregator(32, mode)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(lengths),
                     jnp.asarray(pad)).get("params", {})
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(lengths), jnp.asarray(pad))
    module = layers.Aggregator(32, mode)
    if mode == "gru":
        module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                                _gru_params(_np_tree(params["GRUCell_0"])).items()})
    else:
        rename = {("map_fc1",): "map.0", ("map_fc2",): "map.2",
                  ("gated", "gate_fc1"): "gated_aggr.gate_fn.0",
                  ("gated", "gate_fc2"): "gated_aggr.gate_fn.2",
                  ("gated", "node_fc1"): "gated_aggr.node_fn.0",
                  ("gated", "node_fc2"): "gated_aggr.node_fn.2"}
        _load(module, _np_tree(params), rename)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x), torch.from_numpy(lengths), torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mode", [None, "mean", "gated", "transformer"])
def test_depth_aggregator_matches_flax(rng, mode):
    x = rng.randn(4, 3, 7, 32).astype(np.float32)
    _, _, pad = _tokens(rng)
    jm = jlayers.DepthAggregator(mode, 32)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(pad)).get("params", {})
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(pad))
    module = ALADIN(ExperimentConfig.from_dict(_recipe({"depth-aggregation-matching": mode})),
                    BertImgConfig(**SMALL)).depth_aggregator_model_matching if mode else \
        layers.DepthAggregator(mode, 32)
    tree = {"depth_aggregator_matching": _np_tree(params)}
    sd = {k[len("depth_aggregator_model_matching."):]: v
          for k, v in state_dict_from_flax(tree).items()}
    module.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x), torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_feature_fusion_matches_flax(rng):
    a, b = rng.randn(3, 7, 32).astype(np.float32), rng.randn(3, 7, 32).astype(np.float32)
    jm = jlayers.FeatureFusion(32)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(a), jnp.asarray(b))["params"]
    want = jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b))
    sd = {k[len("feature_fusion."):]: v for k, v in
          state_dict_from_flax({"feature_fusion": _np_tree(params)}).items()}
    module = layers.FeatureFusion(32)
    module.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kind", ["text", "grid", "grid_start", "boxes_sum", "boxes_concat"])
def test_positional_encodings_match_flax(rng, kind):
    x = rng.randn(2, 9, 32).astype(np.float32)
    boxes = np.sort(rng.rand(2, 9, 4).astype(np.float32), axis=-1)
    if kind == "text":
        jm, module, args = jlayers.PositionalEncodingText(32), layers.PositionalEncodingText(32), ()
    elif kind.startswith("grid"):
        jm, module = jlayers.PositionalEncodingImageGrid(32, 3), \
            layers.PositionalEncodingImageGrid(32, 3)
        args = (kind == "grid_start",)
        x = x[:, :10 if kind == "grid_start" else 9]
    else:
        mode = "project-and-sum" if kind == "boxes_sum" else "concat-and-process"
        jm = jlayers.PositionalEncodingImageBoxes(32, mode)
        module = layers.PositionalEncodingImageBoxes(32, mode)
        args = (jnp.asarray(boxes),)
    params = jm.init(jax.random.PRNGKey(6), jnp.asarray(x), *args).get("params", {})
    want = jm.apply({"params": params}, jnp.asarray(x), *args)
    if params:
        _load(module, _np_tree(params), {("map",): "map", ("map_fc1",): "map.0",
                                          ("map_fc2",): "map.2"})
    targs = tuple(torch.from_numpy(np.array(a)) if not isinstance(a, bool) else a for a in args)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x), *targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(layers.sinusoidal_positions(50, 32).numpy(),
                               np.asarray(jlayers.sinusoidal_positions(50, 32)), atol=1e-6)


def test_attention_aggregation_matches_flax(rng):
    img, cap = rng.randn(3, 6, 32).astype(np.float32), rng.randn(3, 7, 32).astype(np.float32)
    img_pad = np.arange(6)[None] >= np.array([6, 2, 4])[:, None]
    _, _, cap_pad = _tokens(rng)
    jm = jagg.SelfAggregation(32, n_head=2)
    args = [jnp.asarray(a) for a in (img, cap, img_pad, cap_pad)]
    params = jm.init(jax.random.PRNGKey(7), *args)["params"]
    want = jm.apply({"params": params}, *args)
    rename = {}
    for side in ("img_aggregation", "cap_aggregation"):
        rename.update({(side, f"head_{i}"): f"{side}.heads.{i}" for i in range(2)})
        rename.update({(side, "out_proj"): f"{side}.out_proj", (side, "norm"): f"{side}.norm"})
    module = _load(agg.SelfAggregation(32, n_head=2), _np_tree(params), rename)
    with torch.no_grad():
        got = module(*(torch.from_numpy(a) for a in (img, cap, img_pad, cap_pad)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    one = jagg.ScoreDotProductAttention(32, temperature=2.0)
    p1 = one.init(jax.random.PRNGKey(8), jnp.asarray(cap), jnp.asarray(cap_pad))["params"]
    m1 = _load(agg.ScoreDotProductAttention(32, temperature=2.0), _np_tree(p1), {(): ""})
    with torch.no_grad():
        np.testing.assert_allclose(
            m1(torch.from_numpy(cap), torch.from_numpy(cap_pad)).numpy(),
            np.asarray(one.apply({"params": p1}, jnp.asarray(cap), jnp.asarray(cap_pad))),
            atol=ATOL)


def test_variant_with_dropout_trains(rng):
    """Dropout 0.1 through every variant module: a few steps lower the loss."""
    d = _recipe(VARIANTS["both_gated_post1"] | {"teran-layers": 1})
    d["model"]["dropout"] = 0.1
    model = ALADIN(ExperimentConfig.from_dict(d), BertImgConfig(**SMALL))
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = TrainState(ExperimentConfig.from_dict(d), model, steps_per_epoch=10)
    step = make_train_step(model, state.cfg)
    batch = _torch_batch(make_batch(rng))
    losses = [step(state, batch, 0)["loss"].item() for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_unknown_depth_aggregation_raises():
    with pytest.raises(ValueError, match="depth aggregation"):
        layers.DepthAggregator("max", 32)
