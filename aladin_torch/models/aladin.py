"""The ALADIN model: disentangled dual-pass OSCAR backbone + two heads
(mirrors aladin_tpu/models/aladin.py for the branch the shipped recipes run).

  * caption branch: backbone over caption tokens only;
  * image branch: backbone over OD-label tokens + projected regions; the
    region outputs are the slice [L_t : L_t + R];
  * matching head: a tern-layers-deep TransformerEncoder over each token
    set; its position-0 output is the global embedding;
  * alignment head: the token sets themselves, l2-normalised (eps 1e-12);
  * globals l2-normalised by bare division.

Module names follow the released ``.pth.tar`` (``oscar_model.bert.*``,
``final_projection_net.layers.*``): its ``img_txt_enc.`` keys load with
``load_state_dict`` after removing that prefix. Depth aggregation, the
TERAN stacks (teran-layers > 0) and the post-OSCAR encoder are not ported
yet and raise.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from aladin_torch.config import ExperimentConfig
from aladin_torch.models.bert_img import BertImgConfig, BertImgModel
from aladin_torch.models.layers import TorchTransformerEncoder
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
        if mc.depth_aggregation_alignment or mc.depth_aggregation_matching:
            raise NotImplementedError("depth aggregation is not ported yet (ROADMAP.md, queue 1)")
        if mc.teran_layers > 0 and mc.text_aggregation is not None:
            raise NotImplementedError("TERAN stacks (teran-layers > 0) are not ported yet "
                                      "(ROADMAP.md, queue 1)")
        self.cfg = cfg
        self.regularize_hidden = "regularizehidden" in cfg.training.loss_types
        self.oscar_model = _Oscar(bert_cfg)
        self.final_projection_net = TorchTransformerEncoder(
            mc.tern_layers, mc.embed_size, nhead=4, dim_feedforward=mc.embed_size,
            dropout=mc.dropout)

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
        backbone = self.oscar_model.bert
        need_hidden = self.regularize_hidden
        txt_seq, _, txt_hidden, _ = backbone(batch.txt_ids, batch.txt_mask, batch.txt_type,
                                             None, output_hidden_states=need_hidden)
        img_seq, _, img_hidden, _ = backbone(batch.img_ids, batch.img_mask, batch.img_type,
                                             batch.img_feats, output_hidden_states=need_hidden)
        l_t = batch.txt_ids.shape[1]
        r = batch.img_feats.shape[1]
        txt_pad = padding_mask(batch.cap_len, l_t)
        img_pad = padding_mask(batch.img_len, r)
        cap_set = txt_seq[:, :l_t]
        img_set = img_seq[:, l_t:l_t + r]

        if need_hidden:
            l1_img = img_hidden[:, :, l_t:l_t + r].abs().sum(-1).mean()
            l1_txt = txt_hidden[:, :, :l_t].abs().sum(-1).mean()
            l1_reg = 0.001 * (l1_img + l1_txt).float() / 2.0
        else:
            l1_reg = torch.zeros((), dtype=torch.float32, device=img_set.device)

        cap_global = self.final_projection_net(cap_set, txt_pad)[:, 0, :]
        img_global = self.final_projection_net(img_set, img_pad)[:, 0, :]
        return AladinOutputs(
            img_global=l2norm(img_global.float()),
            cap_global=l2norm(cap_global.float()),
            img_set=l2norm(img_set.float(), eps=1e-12),
            cap_seq=l2norm(cap_set.float(), eps=1e-12),
            img_len=batch.img_len,
            cap_len=batch.cap_len,
            l1_reg=l1_reg,
        )
