"""The cells' inputs, made on the device from the run's seed and the
traffic file's parameters: the same seed gives the same inputs, and a
reference can make them again after the program's state is gone.

Token ids follow BERT's uncased vocabulary: [PAD] 0, [CLS] 101, [SEP] 102,
[MASK] 103, words drawn from 1000 up.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from h100_bench.lib.traffic import generator, lengths

PAD, CLS, SEP, MASK = 0, 101, 102, 103
FIRST_WORD = 1000

# generator streams of one run
S_WEIGHTS, S_TENSORS, S_SAMPLE, S_ORDER, S_DROPOUT = 1, 3, 4, 5, 6
S_CAPTIONS, S_LABELS, S_REGIONS = 11, 12, 13  # the length multisets' orders


def _ids(gen, shape, vocab: int, device) -> torch.Tensor:
    return torch.randint(FIRST_WORD, vocab, shape, generator=gen, device=device)


def framed(words: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[CLS] words [SEP] [PAD]...: row i holds lens[i] tokens in all."""
    pos = torch.arange(words.shape[1], device=words.device)[None, :]
    lens = lens[:, None]
    ids = torch.where(pos < lens - 1, words, PAD)
    ids = torch.where(pos == lens - 1, SEP, ids)
    return torch.where(pos == 0, CLS, ids)


def region_features(gen, shape, device) -> torch.Tensor:
    """VinVL-like region features: the 2048 pooled dimensions ReLU'd
    normal draws, the last six box coordinates in [0, 1)."""
    f = torch.randn(shape, generator=gen, device=device).clamp_(min=0)
    f[..., -6:] = torch.rand((*shape[:-1], 6), generator=gen, device=device)
    return f


def aladin_batches(c: dict, tr: dict, seed: int, device, n_batches: int) -> List[Dict]:
    """``n_batches`` disentangled retrieval batches of ``c["bs"]`` rows:
    captions of the traffic's caption lengths, OD-label tokens of its label
    lengths, regions of its region counts (fields of the port's ``Batch``)."""
    b, lt, r = c["bs"], c["max_seq_length"], c["max_img_seq_length"]
    n = n_batches * b
    cap_len = torch.as_tensor(lengths(tr["caption_tokens"], n, seed, S_CAPTIONS), device=device)
    lab_len = torch.as_tensor(lengths(tr["label_tokens"], n, seed, S_LABELS), device=device)
    img_len = torch.as_tensor(lengths(tr["regions"], n, seed, S_REGIONS), device=device)
    gen = generator(seed, S_TENSORS, device)
    txt = framed(_ids(gen, (n, lt), c["vocab_size"], device), cap_len)
    lab = framed(_ids(gen, (n, lt), c["vocab_size"], device), lab_len)
    feats = region_features(gen, (n, r, c["img_feature_dim"]), device)
    pos_l = torch.arange(lt, device=device)[None, :]
    pos_r = torch.arange(r, device=device)[None, :]
    feats *= (pos_r < img_len[:, None])[..., None]
    i32 = torch.int32
    fields = {
        "txt_ids": txt.to(i32), "txt_mask": (pos_l < cap_len[:, None]).to(i32),
        "txt_type": torch.zeros(n, lt, dtype=i32, device=device), "cap_len": cap_len.to(i32),
        "img_ids": lab.to(i32),
        "img_mask": torch.cat([pos_l < lab_len[:, None], pos_r < img_len[:, None]], 1).to(i32),
        "img_type": torch.ones(n, lt, dtype=i32, device=device),
        "img_feats": feats, "img_len": img_len.to(i32)}
    return [{k: v[i * b:(i + 1) * b] for k, v in fields.items()} for i in range(n_batches)]


def decode_mask(max_seq_a: int, max_seq: int, max_img: int, od_len: torch.Tensor,
                img_len: torch.Tensor) -> torch.Tensor:
    """(B, L, L) int32 block mask of captioning's decode (OSCAR's
    run_captioning layout): a causal triangle over the caption slots, the
    caption sees the valid labels and regions, labels and regions see each
    other and never the caption."""
    total = max_seq + max_img
    pos = torch.arange(total, device=od_len.device)
    cap = pos < max_seq_a
    lab = (pos[None, :] >= max_seq_a) & (pos[None, :] < max_seq_a + od_len[:, None])
    reg = (pos[None, :] >= max_seq) & (pos[None, :] < max_seq + img_len[:, None])
    ctx = lab | reg  # (B, L)
    tri = pos[:, None] >= pos[None, :]
    cap_rows = cap[None, :, None] & ((cap[None, None, :] & tri[None]) | ctx[:, None, :])
    ctx_rows = ctx[:, :, None] & ctx[:, None, :]
    return (cap_rows | ctx_rows).to(torch.int32)


def caption_batches(c: dict, tr: dict, seed: int, device, n_batches: int) -> List[Dict]:
    """``n_batches`` decode batches of ``tr["batch"]`` images: OD-label ids
    ([SEP]-terminated, token type 1) padded to max_seq - max_seq_a,
    region features padded to max_img_seq, and the decode mask."""
    b = tr["batch"]
    la, lt, li = c["max_seq_a_length"], c["max_seq_length"], c["max_img_seq_length"]
    n = n_batches * b
    od_len = torch.as_tensor(lengths(tr["label_tokens"], n, seed, S_LABELS), device=device)
    img_len = torch.as_tensor(lengths(tr["regions"], n, seed, S_REGIONS), device=device)
    gen = generator(seed, S_TENSORS, device)
    width = lt - la
    pos = torch.arange(width, device=device)[None, :]
    words = _ids(gen, (n, width), c["vocab_size"], device)
    od = torch.where(pos < od_len[:, None] - 1, words, PAD)
    od = torch.where(pos == od_len[:, None] - 1, SEP, od)
    feats = region_features(gen, (n, li, c["img_feature_dim"]), device)
    feats *= (torch.arange(li, device=device)[None, :] < img_len[:, None])[..., None]
    seg = (pos < od_len[:, None]).to(torch.int32)
    mask = decode_mask(la, lt, li, od_len, img_len)
    out = []
    for i in range(n_batches):
        s = slice(i * b, (i + 1) * b)
        out.append({"od_ids": od[s].to(torch.int32), "od_seg": seg[s], "img_feats": feats[s],
                    "attn_mask": mask[s], "od_len": od_len[s], "img_len": img_len[s]})
    return out


def token_sets(tr: dict, seed: int, device, d: int):
    """The alignment head's evaluation buffers: ``tr["images"]`` region
    token sets (R slots) and ``tr["captions_per_image"]`` caption token sets
    (W slots) an image, every vector l2-normalised, lengths with the
    special tokens. Caption c describes image c // captions_per_image: each
    of its words leans towards one of that image's valid regions by
    ``tr["signal"]`` (a unit vector a + ``signal`` x the region, then
    normalised), so the ground truth ranks high, as a trained head's does.

    With ``tr["global_signal"]``, slot 0 of a caption is its global
    embedding and leans the same way towards slot 0 of its image (the
    packing of ``eval/encode``'s buffers, which stage 1 of search reads).

    Returns (images (N, R, d), captions (5N, W, d), image lengths,
    caption lengths), f32 on ``device``."""
    n_im, k = tr["images"], tr["captions_per_image"]
    r, w = tr["region_slots"], tr["word_slots"]
    n_cap = n_im * k
    il = torch.as_tensor(lengths(tr["regions"], n_im, seed, S_REGIONS), device=device)
    cl = torch.as_tensor(lengths(tr["caption_tokens"], n_cap, seed, S_CAPTIONS), device=device)
    gen = generator(seed, S_TENSORS, device)
    ims = torch.randn(n_im, r, d, generator=gen, device=device)
    ims /= ims.norm(dim=-1, keepdim=True)
    owner = torch.arange(n_cap, device=device) // k
    # each word's region: one of its image's valid, non-special slots
    pick = torch.rand(n_cap, w, generator=gen, device=device)
    slot = 1 + (pick * (il[owner] - 1)[:, None].float()).long()
    caps = torch.randn(n_cap, w, d, generator=gen, device=device)
    caps /= caps.norm(dim=-1, keepdim=True)
    for lo in range(0, n_cap, 4096):  # bounded gather
        hi = min(lo + 4096, n_cap)
        caps[lo:hi] += tr["signal"] * ims[owner[lo:hi, None], slot[lo:hi]]
    caps /= caps.norm(dim=-1, keepdim=True)
    if "global_signal" in tr:  # slot 0 holds the global embedding (search's packing)
        g = torch.randn(n_cap, d, generator=gen, device=device)
        g = g / g.norm(dim=-1, keepdim=True) + tr["global_signal"] * ims[owner, 0]
        caps[:, 0] = g / g.norm(dim=-1, keepdim=True)
    return ims, caps, il.to(torch.int32), cl.to(torch.int32)
