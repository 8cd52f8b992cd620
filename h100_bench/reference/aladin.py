"""Plain PyTorch ALADIN training step, the flagship recipe
``alad-alignment-and-matching-distill`` (Messina et al., CBMI 2022,
github.com/mesnico/ALADIN): written from the paper and the recipe, with
no program code.

  * two passes of the VinVL backbone (``reference/bert.py``): the caption
    tokens alone, and the OD-label tokens with the projected regions;
  * token sets: the caption's text outputs and the image's region
    outputs, l2-normalised (norm floored at 1e-12);
  * matching head: a 2-layer ``nn.TransformerEncoder`` (post-LN, relu,
    LayerNorm eps 1e-5, 4 heads, feed-forward = hidden, key padding as
    -inf) over each token set, its first output the global embedding,
    divided by its norm;
  * alignment head: MrSw, sum over words of the max over regions of the
    token cosines, with the image's first slot and the caption's first
    and last two slots stripped and padding zeroed;
  * loss: the alignment scores' bidirectional hinge (margin 0.2, hardest
    negative) plus ListNet distillation from the detached alignment
    scores to the matching scores (temperature 6, eps 1e-10); both score
    matrices in float32, as the recipe computes them whatever the
    backbone's precision;
  * Adam (b1 0.9, b2 0.999, eps 1e-8) after a global-norm clip of the
    gradients that exist (the pooler's output is unused: it gets none);
  * dropout at the recipe's rates, its masks drawn from the run's seed as
    the program draws them (``reference/dropout.py``): in the backbone, and
    in the matching head on the attention probabilities, the attention
    output, the feed-forward hidden layer and its output.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from h100_bench.reference import bert
from h100_bench.reference.dropout import Dropouts
from h100_bench.reference.precision import Precision

BERT = "oscar_model.bert."
HEAD = "final_projection_net.layers."


def spec(c: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    out = bert.spec(BERT, c["vocab_size"], c["hidden_size"], c["num_hidden_layers"],
                    c["intermediate_size"], c["max_position_embeddings"], c["type_vocab_size"],
                    c["img_feature_dim"])
    h = c["hidden_size"]
    ff = c["tern_dim_feedforward"]
    for n in range(c["tern_layers"]):
        p = f"{HEAD}{n}."
        out += [(p + "self_attn.in_proj_weight", (3 * h, h)), (p + "self_attn.in_proj_bias", (3 * h,)),
                (p + "self_attn.out_proj.weight", (h, h)), (p + "self_attn.out_proj.bias", (h,)),
                (p + "linear1.weight", (ff, h)), (p + "linear1.bias", (ff,)),
                (p + "linear2.weight", (h, ff)), (p + "linear2.bias", (h,)),
                (p + "norm1.weight", (h,)), (p + "norm1.bias", (h,)),
                (p + "norm2.weight", (h,)), (p + "norm2.bias", (h,))]
    return out


def te_layer(W, p: str, x: torch.Tensor, pad: torch.Tensor, heads: int, prec: Precision,
             drop: Dropouts):
    b, s, h = x.shape
    rate = drop.matching
    d = h // heads
    qkv = prec.linear(x, W[p + "self_attn.in_proj_weight"], W[p + "self_attn.in_proj_bias"])
    q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    scores = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
    scores = scores.masked_fill(pad[:, None, None, :], float("-inf"))
    probs = drop.apply(torch.softmax(scores, dim=-1), rate)
    ctx = prec.matmul(probs, v).transpose(1, 2).reshape(b, s, h)
    a = prec.linear(ctx, W[p + "self_attn.out_proj.weight"], W[p + "self_attn.out_proj.bias"])
    x = F.layer_norm(x + drop.apply(a, rate), (h,), W[p + "norm1.weight"], W[p + "norm1.bias"],
                     1e-5)
    hid = drop.apply(torch.relu(prec.linear(x, W[p + "linear1.weight"], W[p + "linear1.bias"])),
                     rate)
    ff = prec.linear(hid, W[p + "linear2.weight"], W[p + "linear2.bias"])
    return F.layer_norm(x + drop.apply(ff, rate), (h,), W[p + "norm2.weight"],
                        W[p + "norm2.bias"], 1e-5)


def l2norm(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = x.norm(dim=-1, keepdim=True)
    return x / (n.clamp(min=eps) if eps else n)


def mrsw(im_set: torch.Tensor, cap_seq: torch.Tensor, im_len: torch.Tensor,
         cap_len: torch.Tensor) -> torch.Tensor:
    """(B_i, B_c) MrSw scores of normalised, un-stripped token sets, in
    float32."""
    im, cap = im_set[:, 1:], cap_seq[:, 1:-2]
    il, cl = im_len - 1, cap_len - 3
    bi, r, d = im.shape
    bc, w, _ = cap.shape
    im = im * (torch.arange(r, device=im.device)[None, :] < il[:, None])[..., None]
    cap = cap * (torch.arange(w, device=cap.device)[None, :] < cl[:, None])[..., None]
    align = torch.matmul(im.reshape(bi * r, d), cap.reshape(bc * w, d).t()).reshape(bi, r, bc, w)
    return align.amax(dim=1).sum(dim=-1)


def hinge(scores: torch.Tensor, margin: float) -> torch.Tensor:
    """Bidirectional hinge over the in-batch matrix, hardest negative each way."""
    diag = scores.diagonal()
    off = ~torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    cost_s = torch.where(off, (margin + scores - diag[:, None]).clamp(min=0), 0.0)
    cost_im = torch.where(off, (margin + scores - diag[None, :]).clamp(min=0), 0.0)
    return cost_s.amax(dim=1).sum() + cost_im.amax(dim=0).sum()


def listnet(teacher: torch.Tensor, student: torch.Tensor, temperature: float) -> torch.Tensor:
    total = 0.0
    for dim in (1, 0):
        p = torch.softmax(student * temperature, dim=dim) + 1e-10
        q = torch.softmax(teacher, dim=dim)
        total = total + (-(q * torch.log(p)).sum(dim=dim)).mean()
    return total


def loss(W: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], c: dict,
         prec: Precision, drop: Dropouts) -> torch.Tensor:
    layers, heads = c["num_hidden_layers"], c["num_attention_heads"]
    txt = bert.backbone(W, BERT, batch["txt_ids"], batch["txt_mask"], batch["txt_type"], None,
                        layers, heads, prec, drop)
    img = bert.backbone(W, BERT, batch["img_ids"], batch["img_mask"], batch["img_type"],
                        batch["img_feats"], layers, heads, prec, drop)
    lt, r = batch["txt_ids"].shape[1], batch["img_feats"].shape[1]
    cap_tokens, img_tokens = txt[:, :lt], img[:, lt:lt + r]
    txt_pad = torch.arange(lt, device=txt.device)[None, :] >= batch["cap_len"][:, None]
    img_pad = torch.arange(r, device=img.device)[None, :] >= batch["img_len"][:, None]
    cg, ig = cap_tokens, img_tokens
    for n in range(c["tern_layers"]):  # the caption's whole stack first, as the program runs it
        cg = te_layer(W, f"{HEAD}{n}.", cg, txt_pad, c["tern_heads"], prec, drop)
    for n in range(c["tern_layers"]):
        ig = te_layer(W, f"{HEAD}{n}.", ig, img_pad, c["tern_heads"], prec, drop)
    cap_global, img_global = l2norm(cg[:, 0]), l2norm(ig[:, 0])
    teacher = mrsw(l2norm(img_tokens, 1e-12), l2norm(cap_tokens, 1e-12), batch["img_len"],
                   batch["cap_len"])
    matching = torch.matmul(img_global, cap_global.t())
    return hinge(teacher, c["margin"]) + listnet(teacher.detach(), matching,
                                                 c["distillation_temperature"])


def train(W0: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]], c: dict,
          prec: Precision, change_after: int, dropout_seed: int) -> dict:
    """Adam from ``W0`` over ``batches``, one step each, the dropout masks
    drawn from ``dropout_seed``: the loss of every step; each leaf's first
    gradient as the clip hands it to Adam (``grad``) and the norm of the
    gradient as it came; each leaf's change after ``change_after`` steps
    (``change``)."""
    drop = Dropouts(c, dropout_seed, next(iter(W0.values())).device)
    names = list(W0)
    params = {n: W0[n].detach().clone().float().requires_grad_(True) for n in names}
    b1, b2, eps, lr = c["adam_beta1"], c["adam_beta2"], c["adam_eps"], c["lr"]
    m: Dict[str, torch.Tensor] = {}
    v: Dict[str, torch.Tensor] = {}
    out = {"losses": []}
    with prec.context():
        for t, batch in enumerate(batches, 1):
            total = loss(params, batch, c, prec, drop)
            grads = torch.autograd.grad(total, [params[n] for n in names], allow_unused=True)
            out["losses"].append(float(total.detach()))
            g = {n: gr for n, gr in zip(names, grads) if gr is not None}
            norm = torch.sqrt(sum((gr.float() ** 2).sum() for gr in g.values()))
            scale = torch.where(norm < c["grad_clip"], torch.ones_like(norm), c["grad_clip"] / norm)
            if t == 1:
                out["raw_grad_norm"] = {n: float(gr.norm()) for n, gr in g.items()}
                out["grad"] = {n: (gr * scale).detach() for n, gr in g.items()}
            with torch.no_grad():
                for n, gr in g.items():
                    gr = gr * scale
                    m[n] = m.get(n, torch.zeros_like(gr)).mul_(b1).add_(gr, alpha=1 - b1)
                    v[n] = v.get(n, torch.zeros_like(gr)).mul_(b2).addcmul_(gr, gr, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                    params[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
            if t == change_after:
                out["change"] = {n: params[n].detach() - W0[n].float() for n in names}
    return out
