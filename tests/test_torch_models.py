"""The port's backbone, matching head and ALADIN forward against aladin_tpu
on the CPU, with weights carried across by ``state_dict_from_flax``.

Same seeded Flax parameters and numpy inputs through both packages, f32,
dropout off. Tolerance atol 1e-4 throughout: the same f32 math summed in
another order (observed differences ~1e-6).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.config import ExperimentConfig as JaxExperimentConfig
from aladin_tpu.io.convert import load_aladin_checkpoint as jax_load_aladin
from aladin_tpu.io.convert import load_oscar_checkpoint as jax_load_oscar
from aladin_tpu.models.aladin import ALADIN as JaxALADIN
from aladin_tpu.models.bert_img import BertImgConfig as JaxBertImgConfig
from aladin_tpu.models.bert_img import BertImgModel as JaxBertImgModel
from aladin_tpu.models.layers import TorchTransformerEncoder as JaxTE
from aladin_torch.config import ExperimentConfig
from aladin_torch.io.checkpoint import load_state_dict_report
from aladin_torch.io.convert import (bert_state_dict, load_aladin_checkpoint,
                                     load_oscar_checkpoint, state_dict_from_flax, te_state_dict)
from aladin_torch.models.aladin import ALADIN, Batch
from aladin_torch.models.bert_img import BertImgConfig, BertImgModel
from aladin_torch.models.layers import TorchTransformerEncoder
from tests.test_interop_reference_layout import build_reference_module
from tests.test_models import SMALL, make_batch

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(jb) -> Batch:
    return Batch(**{f: torch.from_numpy(np.array(getattr(jb, f)))
                    for f in Batch.__dataclass_fields__})


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(got, "detach") else got),
                               np.asarray(want), atol=atol)


def _backbone_inputs(rng, b=3, l=10, r=6):
    ids = rng.randint(3, SMALL["vocab_size"], (b, l)).astype(np.int32)
    typ = rng.randint(0, 2, (b, l)).astype(np.int32)
    txt_mask = (np.arange(l)[None] < rng.randint(4, l + 1, b)[:, None]).astype(np.int32)
    feats = rng.randn(b, r, SMALL["img_feature_dim"]).astype(np.float32)
    img_mask = np.concatenate(
        [txt_mask, (np.arange(r)[None] < rng.randint(2, r + 1, b)[:, None]).astype(np.int32)],
        axis=1)
    return ids, typ, txt_mask, feats, img_mask


@pytest.mark.parametrize("variant", ["gelu", "gelu_tanh", "fused_qkv"])
def test_backbone_text_and_image_paths(rng, variant):
    """Sequence output, pooler, all 3 hidden states (L+1) and the attention
    probabilities, on the text-only and the image path."""
    knobs = {"fused_qkv": True} if variant == "fused_qkv" else {"hidden_act": variant}
    jcfg = JaxBertImgConfig(**SMALL, **knobs)
    ids, typ, txt_mask, feats, img_mask = _backbone_inputs(rng)
    jmodel = JaxBertImgModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(ids), jnp.asarray(img_mask),
                         jnp.asarray(typ), jnp.asarray(feats))["params"]
    model = BertImgModel(BertImgConfig(**SMALL, **knobs)).eval()
    model.load_state_dict(bert_state_dict(_np_tree(params)), strict=True)
    for img, mask in ((None, txt_mask), (feats, img_mask)):
        want = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                            jnp.asarray(typ), None if img is None else jnp.asarray(img), True,
                            output_attentions=True, output_hidden_states=True)
        with torch.no_grad():
            got = model(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(typ),
                        None if img is None else torch.from_numpy(img), output_attentions=True,
                        output_hidden_states=True)
        assert got[2].shape == (SMALL["num_hidden_layers"] + 1, *got[0].shape)
        for g, w in zip(got, want):
            _close(g, w)


def test_kernel_knobs_build():
    """Every kernel knob builds (quant_matmuls alone and with fused_layernorm,
    fused_attention, fused_layernorm), with the state-dict keys and shapes
    of the plain backbone."""
    plain = {k: v.shape for k, v in BertImgModel(BertImgConfig(**SMALL)).state_dict().items()}
    for knobs in ({"quant_matmuls": True}, {"quant_matmuls": True, "fused_layernorm": True},
                  {"fused_attention": True}, {"fused_layernorm": True}):
        model = BertImgModel(BertImgConfig(**SMALL, **knobs))
        assert {k: v.shape for k, v in model.state_dict().items()} == plain, knobs


def test_matching_head_encoder(rng):
    """torch.nn.TransformerEncoder semantics: post-LN, relu, eps 1e-5,
    -inf key padding; weights through te_state_dict."""
    x = rng.randn(3, 7, 32).astype(np.float32)
    pad = np.arange(7)[None] >= np.array([7, 3, 1])[:, None]
    jte = JaxTE(2, 32, nhead=4, dim_feedforward=32)
    params = jte.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(pad))["params"]
    want = jte.apply({"params": params}, jnp.asarray(x), jnp.asarray(pad))
    te = TorchTransformerEncoder(2, 32, nhead=4, dim_feedforward=32).eval()
    te.load_state_dict(te_state_dict(_np_tree(params)), strict=True)
    with torch.no_grad():
        _close(te(torch.from_numpy(x), torch.from_numpy(pad)), want)


def _jax_aladin(model_over=None):
    d = {"model": {"embed-size": SMALL["hidden_size"], "tern-layers": 2, "teran-layers": 0,
                   **(model_over or {})},
         "training": {"loss-type": "alignment-distillation", "loss-weights": [1, 1], "bs": 4}}
    return JaxALADIN(JaxExperimentConfig.from_dict(d), JaxBertImgConfig(**SMALL)), d


def _compare_outputs(got, want):
    for f in ("img_global", "cap_global", "img_set", "cap_seq", "img_len", "cap_len", "l1_reg"):
        _close(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("loss_type", ["alignment-distillation", "alignment-regularizehidden"])
def test_aladin_forward_with_carried_weights(rng, loss_type):
    """The whole forward (both passes, region slice, matching head token 0,
    final l2norms, the optional L1 regulariser)."""
    _, d = _jax_aladin()
    d["training"]["loss-type"] = loss_type
    jmodel = JaxALADIN(JaxExperimentConfig.from_dict(d), JaxBertImgConfig(**SMALL))
    jbatch = make_batch(rng)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, True)["params"]
    want = jmodel.apply({"params": params}, jbatch, True)
    model = ALADIN(ExperimentConfig.from_dict(d), BertImgConfig(**SMALL)).eval()
    model.load_state_dict(state_dict_from_flax(_np_tree(params)), strict=True)
    with torch.no_grad():
        _compare_outputs(model(_torch_batch(jbatch)), want)


def test_released_pth_tar_layout_loads(rng, tmp_path):
    """A .pth.tar whose keys torch itself named in the released layout
    (img_txt_enc.oscar_model.bert.*, final_projection_net.layers.*):
    every port tensor loads by prefix removal alone, only the reference's
    unused modules are left over, and the forward matches aladin_tpu's on
    the same file."""
    path = str(tmp_path / "model_best_rsum.pth.tar")
    ref = build_reference_module(tern_layers=1)
    _, d = _jax_aladin({"tern-layers": 1})
    torch.save({"epoch": 3, "model": ref.state_dict(), "optimizer": {}, "scheduler": {},
                "opt": {}, "config": d, "Eiters": 9}, path)

    sd, cfg_back, meta = load_aladin_checkpoint(path)
    assert meta == {"epoch": 3, "Eiters": 9} and cfg_back["model"]["tern-layers"] == 1
    model = ALADIN(ExperimentConfig.from_dict(cfg_back), BertImgConfig(**SMALL)).eval()
    stats = load_state_dict_report(model, sd)
    assert stats["missing"] == []
    assert {k.split(".")[0] for k in stats["unused"]} <= {"img_proj", "cap_proj", "oscar_model"}
    assert all("classifier" in k for k in stats["unused"] if k.startswith("oscar_model."))

    tree, _, _ = jax_load_aladin(path)
    jmodel, _ = _jax_aladin({"tern-layers": 1})
    jbatch = make_batch(rng)
    want = jmodel.apply({"params": tree}, jbatch, True)
    with torch.no_grad():
        _compare_outputs(model(_torch_batch(jbatch)), want)


def test_oscar_directory_loads_in_both(rng, tmp_path):
    """config.json + pytorch_model.bin (bert.-prefixed): the port's loader
    and aladin_tpu's read the same backbone."""
    cfg = BertImgConfig(**SMALL)
    src = BertImgModel(cfg)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in src.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(cfg.to_json_dict(), f)
    torch.save({"bert." + k: v for k, v in src.state_dict().items()},
               os.path.join(tmp_path, "pytorch_model.bin"))

    sd, cfg_back = load_oscar_checkpoint(str(tmp_path))
    assert cfg_back == cfg
    model = BertImgModel(cfg_back).eval()
    model.load_state_dict(sd, strict=True)
    tree, jcfg = jax_load_oscar(str(tmp_path))
    ids, typ, _, feats, img_mask = _backbone_inputs(rng)
    want = JaxBertImgModel(jcfg).apply({"params": tree["oscar"]}, jnp.asarray(ids),
                                       jnp.asarray(img_mask), jnp.asarray(typ),
                                       jnp.asarray(feats), True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(img_mask), torch.from_numpy(typ),
                    torch.from_numpy(feats))
    _close(got[0], want[0])
    _close(got[1], want[1])
