"""Weights across formats (mirrors aladin_tpu/io/convert.py).

The port's module names are the reference torch names, so:

  * an OSCAR/VinVL directory (``config.json`` + ``pytorch_model.bin``,
    backbone keys under ``bert.``) loads into ``BertImgModel`` after
    removing ``bert.``;
  * a released ALADIN ``.pth.tar`` (a dict {epoch, model, optimizer,
    scheduler, opt, config, Eiters}, model keys under ``img_txt_enc.``)
    loads into ``ALADIN`` after removing ``img_txt_enc.``;
  * ``aladin_tpu``'s Flax parameter tree, as numpy arrays, becomes the
    port's state dict through the inverse of its key maps
    (``state_dict_from_flax``; aladin_tpu/io/convert.py:254-340: the
    backbone, the TE stacks, the gated depth aggregators and the feature
    fusion; the 'transformer' depth mode's ``depth_transformer``, which
    has no reference name, under ``depth_aggregator_model_<side>.
    depth_transformer.`` in the TE layout), and a
    train state's {"model", "aux"} tree becomes the port's named parameters
    (``params_from_flax``). A gradient tree has the same structure, so the
    same maps name its entries. The OSCAR task models' trees (pretraining,
    captioning, classification, multiple choice) map through
    ``task_state_dict_from_flax``, and an OSCAR captioning directory's
    ``pytorch_model.bin`` loads into the captioner through
    ``load_captioner_checkpoint``.

Orbax checkpoint directories are a JAX format and are not read here.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from aladin_torch.models.bert_img import BertImgConfig

# the port's nn.TransformerEncoder-style stacks (Flax module name == torch name)
_TE_STACKS = ("final_projection_net", "transformer_encoder_1", "transformer_encoder_2",
              "post_oscar_transformer")


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _dense(sd: Dict[str, torch.Tensor], key: str, node: Dict[str, Any]) -> None:
    sd[key + ".weight"] = _t(node["kernel"]).T.contiguous()  # Flax (in, out) -> torch (out, in)
    if "bias" in node:
        sd[key + ".bias"] = _t(node["bias"])


def _layernorm(sd: Dict[str, torch.Tensor], key: str, node: Dict[str, Any]) -> None:
    sd[key + ".weight"] = _t(node["scale"])
    sd[key + ".bias"] = _t(node["bias"])


def bert_state_dict(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A Flax ``oscar`` subtree -> BertImgModel state dict."""
    sd: Dict[str, torch.Tensor] = {}
    p = prefix
    sd[p + "embeddings.word_embeddings.weight"] = _t(tree["word_embeddings"]["embedding"])
    sd[p + "embeddings.position_embeddings.weight"] = _t(tree["position_embeddings"]["embedding"])
    sd[p + "embeddings.token_type_embeddings.weight"] = _t(
        tree["token_type_embeddings"]["embedding"])
    _layernorm(sd, p + "embeddings.LayerNorm", tree["embeddings_layernorm"])
    for name, node in tree.items():
        if not name.startswith("layer_"):
            continue
        src = f"{p}encoder.layer.{int(name.split('_')[1])}."
        for q in ("query", "key", "value"):
            _dense(sd, src + f"attention.self.{q}", node["attention"][q])
        _dense(sd, src + "attention.output.dense", node["attention_output"])
        _layernorm(sd, src + "attention.output.LayerNorm", node["attention_layernorm"])
        _dense(sd, src + "intermediate.dense", node["intermediate"])
        _dense(sd, src + "output.dense", node["output"])
        _layernorm(sd, src + "output.LayerNorm", node["output_layernorm"])
    if "img_embedding" in tree:
        _dense(sd, p + "img_embedding", tree["img_embedding"])
    if "img_layernorm" in tree:
        _layernorm(sd, p + "LayerNorm", tree["img_layernorm"])
    if "pooler" in tree:
        _dense(sd, p + "pooler.dense", tree["pooler"])
    return sd


def _attention(sd: Dict[str, torch.Tensor], key: str, node: Dict[str, Any]) -> None:
    """A Flax TorchMultiheadAttention (q/k/v/out Dense) -> nn.MultiheadAttention
    names (q/k/v packed into ``in_proj``)."""
    projs = ("q_proj", "k_proj", "v_proj")
    sd[key + ".in_proj_weight"] = torch.cat(
        [_t(node[k]["kernel"]).T for k in projs], dim=0).contiguous()
    sd[key + ".in_proj_bias"] = torch.cat([_t(node[k]["bias"]) for k in projs])
    _dense(sd, key + ".out_proj", node["out_proj"])


def te_state_dict(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A Flax TorchTransformerEncoder subtree -> nn.TransformerEncoder-style
    state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in tree.items():
        if not name.startswith("layer_"):
            continue
        src = f"{prefix}layers.{int(name.split('_')[1])}."
        _attention(sd, src + "self_attn", node["self_attn"])
        _dense(sd, src + "linear1", node["linear1"])
        _dense(sd, src + "linear2", node["linear2"])
        _layernorm(sd, src + "norm1", node["norm1"])
        _layernorm(sd, src + "norm2", node["norm2"])
    return sd


def state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """aladin_tpu's ALADIN parameter tree (numpy leaves) -> the port's
    ALADIN state dict."""
    sd: Dict[str, torch.Tensor] = {}
    if "oscar" in tree:
        sd.update(bert_state_dict(tree["oscar"], "oscar_model.bert."))
    for name in _TE_STACKS:
        if name in tree:
            sd.update(te_state_dict(tree[name], name + "."))
    for side in ("alignment", "matching"):
        node = tree.get(f"depth_aggregator_{side}", {})
        key = f"depth_aggregator_model_{side}"
        if "self_attn" in node:  # gated
            _attention(sd, key + ".self_attn", node["self_attn"])
            _dense(sd, key + ".gate_ffn", node["gate_ffn"])
        if "depth_transformer" in node:  # no reference name: the TE layout
            sd.update(te_state_dict(node["depth_transformer"], key + ".depth_transformer."))
    if "feature_fusion" in tree:
        _dense(sd, "feature_fusion.alphas.0", tree["feature_fusion"]["fc1"])
        _dense(sd, "feature_fusion.alphas.3", tree["feature_fusion"]["fc2"])
    return sd


def task_state_dict_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """aladin_tpu's parameter tree of an OSCAR task model (numpy leaves) ->
    the port's state dict: ``BertImgForPreTraining`` (the MLM head
    ``cls/{transform_dense, transform_layernorm, decoder_bias}`` ->
    ``cls.predictions.{transform.dense, transform.LayerNorm, bias}``,
    ``seq_relationship`` -> ``cls.seq_relationship``),
    ``BertImageCaptioner`` (the same MLM head and no ``seq_relationship``),
    ``ImageBertClassifier`` (``classifier``) and both multiple-choice heads
    (``cls`` or ``cls_fc1`` / ``cls_fc2``, the same names in both)."""
    sd = bert_state_dict(tree["bert"], "bert.")
    cls = tree.get("cls", {})
    if "transform_dense" in cls:
        _dense(sd, "cls.predictions.transform.dense", cls["transform_dense"])
        _layernorm(sd, "cls.predictions.transform.LayerNorm", cls["transform_layernorm"])
        sd["cls.predictions.bias"] = _t(cls["decoder_bias"])
    if "seq_relationship" in tree:  # pretraining; the captioner has the MLM head alone
        _dense(sd, "cls.seq_relationship", tree["seq_relationship"])
    for name in ("classifier", "cls_fc1", "cls_fc2") + (("cls",) if "kernel" in cls else ()):
        if name in tree:
            _dense(sd, name, tree[name])
    return sd


def aux_from_flax(aux: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """aladin_tpu's aux learnables -> the port's TrainState.aux names
    (``loss_weights.<loss>``, ``distill_wb``); the placeholder ``_`` that
    keeps the Flax tree non-empty has no counterpart."""
    out = {f"loss_weights.{k}": _t(v) for k, v in aux.get("loss_weights", {}).items()}
    if "distill_wb" in aux:
        out["distill_wb"] = _t(aux["distill_wb"])
    return out


def params_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A train state's {"model": ..., "aux": ...} tree (or its gradient
    tree) -> {model state-dict name or ``aux.<name>``: tensor}."""
    out = state_dict_from_flax(params["model"])
    out.update({f"aux.{k}": v for k, v in aux_from_flax(params.get("aux", {})).items()})
    return out


def _strip_prefix(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_oscar_checkpoint(checkpoint_dir: str) -> Tuple[Dict[str, torch.Tensor], BertImgConfig]:
    """OSCAR/VinVL directory -> (BertImgModel state dict, BertImgConfig)."""
    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        cfg = BertImgConfig.from_json_dict(json.load(f))
    sd = torch.load(os.path.join(checkpoint_dir, "pytorch_model.bin"), map_location="cpu",
                    weights_only=True)
    return _strip_prefix(sd, "bert."), cfg


def load_aladin_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any], Dict]:
    """Released ``.pth.tar`` -> (ALADIN state dict, embedded config dict,
    {epoch, Eiters}). The file holds the reference's pickled options, so it
    is read with ``weights_only=False``: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = _strip_prefix(ckpt["model"], "img_txt_enc.")
    meta = {"epoch": ckpt.get("epoch", 0), "Eiters": ckpt.get("Eiters", 0)}
    return sd, ckpt.get("config") or {}, meta


def captioner_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An OSCAR checkpoint's state dict (``bert.*``, ``cls.predictions.*``)
    -> the port's ``BertImageCaptioner`` keys: the backbone and the MLM head
    as they are, without the tied decoder's copy of the word embeddings
    (``cls.predictions.decoder.weight``: the head reads the table itself)
    and without a pretraining checkpoint's ``cls.seq_relationship``."""
    return {k: v for k, v in sd.items()
            if k.startswith("bert.") or (k.startswith("cls.predictions.")
                                         and k != "cls.predictions.decoder.weight")}


def load_captioner_checkpoint(checkpoint_dir: str) -> Tuple[Dict[str, torch.Tensor],
                                                           BertImgConfig]:
    """OSCAR captioning directory -> (BertImageCaptioner state dict,
    BertImgConfig)."""
    with open(os.path.join(checkpoint_dir, "config.json")) as f:
        cfg = BertImgConfig.from_json_dict(json.load(f))
    sd = torch.load(os.path.join(checkpoint_dir, "pytorch_model.bin"), map_location="cpu",
                    weights_only=True)
    return captioner_state_dict(sd), cfg
