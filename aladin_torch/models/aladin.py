"""The ALADIN model: disentangled dual-pass OSCAR backbone + two heads
(mirrors aladin_tpu/models/aladin.py).

  * caption branch: backbone over caption tokens only;
  * image branch: backbone over OD-label tokens + projected regions; the
    region outputs are the slice [L_t : L_t + R];
  * depth aggregation (optional) over the 13-entry hidden-state stack: on
    the alignment side the first 12 entries are aggregated and fused with
    the last (``depth_aggregator_model_alignment``, ``feature_fusion``); on
    the matching side the whole stack, with the post-OSCAR TE's output
    appended as one more entry when post-layers > 0
    (``post_oscar_transformer``, ``depth_aggregator_model_matching``);
  * TERAN stacks (teran-layers > 0 with a text aggregation): a TE over
    each token set, shared (``transformer_encoder_1``) or one a modality
    (``transformer_encoder_2`` for the regions); they feed the alignment
    head only;
  * matching head: a tern-layers-deep TransformerEncoder over each token
    set; its position-0 output is the global embedding;
  * alignment head: the token sets themselves, l2-normalised (eps 1e-12);
  * globals l2-normalised by bare division.

The hidden-state stack is kept only when a consumer needs it (depth
aggregation or the ``regularizehidden`` loss). Module names follow the
released ``.pth.tar`` (``oscar_model.bert.*``, ``final_projection_net.layers.*``
and the names above): its ``img_txt_enc.`` keys load with
``load_state_dict`` after removing that prefix.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from aladin_torch.config import ExperimentConfig
from aladin_torch.models.bert_img import BertImgConfig, BertImgModel
from aladin_torch.models.layers import DepthAggregator, FeatureFusion, TorchTransformerEncoder
from aladin_torch.ops.masking import padding_mask
from aladin_torch.ops.similarity import l2norm


@dataclasses.dataclass
class Batch:
    """One disentangled retrieval batch (static shapes)."""

    txt_ids: torch.Tensor  # (B, L_t) int32 caption tokens, CLS...SEP + pad
    txt_mask: torch.Tensor  # (B, L_t) 1/0
    txt_type: torch.Tensor  # (B, L_t) int32 segment ids
    cap_len: torch.Tensor  # (B,) int32 real caption length incl. CLS/SEP
    img_ids: torch.Tensor  # (B, L_t) int32 OD-label tokens
    img_mask: torch.Tensor  # (B, L_t + R) 1/0 over label tokens + regions
    img_type: torch.Tensor  # (B, L_t) int32
    img_feats: torch.Tensor  # (B, R, feat_dim) float region features
    img_len: torch.Tensor  # (B,) int32 number of real regions


@dataclasses.dataclass
class AladinOutputs:
    img_global: torch.Tensor  # (B, D) l2-normalised matching-head image embedding
    cap_global: torch.Tensor  # (B, D) l2-normalised matching-head caption embedding
    img_set: torch.Tensor  # (B, R, D) normalised region token set
    cap_seq: torch.Tensor  # (B, L_t, D) normalised caption token sequence
    img_len: torch.Tensor  # (B,)
    cap_len: torch.Tensor  # (B,)
    l1_reg: torch.Tensor  # scalar hidden-state L1 regulariser (0 unless configured)


class _Oscar(nn.Module):
    """Holds the backbone under ``bert`` (the OSCAR checkpoints' prefix)."""

    def __init__(self, bert_cfg: BertImgConfig):
        super().__init__()
        self.bert = BertImgModel(bert_cfg)


class ALADIN(nn.Module):
    """Disentangled dual encoder with alignment + matching heads."""

    def __init__(self, cfg: ExperimentConfig, bert_cfg: BertImgConfig):
        super().__init__()
        mc = cfg.model
        if mc.embed_size != bert_cfg.hidden_size:
            raise ValueError(f"embed-size ({mc.embed_size}) must match the backbone hidden size "
                             f"({bert_cfg.hidden_size}); the reference's projections are dead code")
        self.cfg = cfg
        self.regularize_hidden = "regularizehidden" in cfg.training.loss_types
        self.oscar_model = _Oscar(bert_cfg)
        embed = mc.embed_size

        def te(layers):
            return TorchTransformerEncoder(layers, embed, nhead=4, dim_feedforward=embed,
                                           dropout=mc.dropout)

        if mc.depth_aggregation_alignment:
            self.depth_aggregator_model_alignment = DepthAggregator(
                mc.depth_aggregation_alignment, embed)
            self.feature_fusion = FeatureFusion(embed)
        if mc.depth_aggregation_matching:
            if mc.post_layers > 0:
                self.post_oscar_transformer = te(mc.post_layers)
            self.depth_aggregator_model_matching = DepthAggregator(
                mc.depth_aggregation_matching, embed)
        self.teran = mc.teran_layers > 0 and mc.text_aggregation is not None
        if self.teran:
            self.transformer_encoder_1 = te(mc.teran_layers)
            if not mc.shared_transformer:
                self.transformer_encoder_2 = te(mc.teran_layers)
        self.final_projection_net = te(mc.tern_layers)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random weights from ``generator``: normal(0, initializer_range)
        matrices and embeddings, zero biases, unit LayerNorm scales."""
        std = self.oscar_model.bert.cfg.initializer_range
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.ndim >= 2:
                    p.copy_(torch.randn(p.shape, generator=generator) * std)
                elif ("LayerNorm" in name or "norm" in name) and name.endswith("weight"):
                    p.fill_(1.0)
                else:
                    p.zero_()

    def forward(self, batch: Batch) -> AladinOutputs:
        mc = self.cfg.model
        backbone = self.oscar_model.bert
        need_hidden = bool(mc.depth_aggregation_alignment or mc.depth_aggregation_matching
                           or self.regularize_hidden)
        txt_seq, _, txt_hidden, _ = backbone(batch.txt_ids, batch.txt_mask, batch.txt_type,
                                             None, output_hidden_states=need_hidden)
        img_seq, _, img_hidden, _ = backbone(batch.img_ids, batch.img_mask, batch.img_type,
                                             batch.img_feats, output_hidden_states=need_hidden)
        l_t = batch.txt_ids.shape[1]
        r = batch.img_feats.shape[1]
        txt_pad = padding_mask(batch.cap_len, l_t)
        img_pad = padding_mask(batch.img_len, r)
        region_hidden = img_hidden[:, :, l_t:l_t + r] if need_hidden else None
        cap_hidden = txt_hidden[:, :, :l_t] if need_hidden else None

        # alignment-side token sets
        if mc.depth_aggregation_alignment:
            da, fuse = self.depth_aggregator_model_alignment, self.feature_fusion
            i_teran = fuse(da(region_hidden[:-1], img_pad), region_hidden[-1])
            c_teran = fuse(da(cap_hidden[:-1], txt_pad), cap_hidden[-1])
        else:
            c_teran = txt_seq[:, :l_t]
            i_teran = img_seq[:, l_t:l_t + r]

        # matching-side inputs
        if mc.depth_aggregation_matching:
            img_stack, cap_stack = region_hidden, cap_hidden
            if mc.post_layers > 0:
                post = self.post_oscar_transformer
                img_stack = torch.cat([img_stack, post(i_teran, img_pad)[None]])
                cap_stack = torch.cat([cap_stack, post(c_teran, txt_pad)[None]])
            dam = self.depth_aggregator_model_matching
            i_emb, c_emb = dam(img_stack, img_pad), dam(cap_stack, txt_pad)
        else:
            i_emb, c_emb = i_teran, c_teran

        # per-modality TERAN stacks
        if self.teran:
            cap_set = self.transformer_encoder_1(c_teran, txt_pad)
            img_te = self.transformer_encoder_1 if mc.shared_transformer \
                else self.transformer_encoder_2
            img_set = img_te(i_teran, img_pad)
        else:
            cap_set, img_set = c_teran, i_teran

        if self.regularize_hidden:
            l1_img = region_hidden.abs().sum(-1).mean()
            l1_txt = cap_hidden.abs().sum(-1).mean()
            l1_reg = 0.001 * (l1_img + l1_txt).float() / 2.0
        else:
            l1_reg = torch.zeros((), dtype=torch.float32, device=img_set.device)

        cap_global = self.final_projection_net(c_emb, txt_pad)[:, 0, :]
        img_global = self.final_projection_net(i_emb, img_pad)[:, 0, :]
        return AladinOutputs(
            img_global=l2norm(img_global.float()),
            cap_global=l2norm(cap_global.float()),
            img_set=l2norm(img_set.float(), eps=1e-12),
            cap_seq=l2norm(cap_set.float(), eps=1e-12),
            img_len=batch.img_len,
            cap_len=batch.cap_len,
            l1_reg=l1_reg,
        )
