"""Offline re-captioning with Kimi-VL's language model: the port's cached
greedy decoder, ``tasks/decode_cache.py::greedy_decode_cached`` (which
hands a latent-cache model to ``tasks/decode_latent.py``), in bf16 on
batches of images one after another.

Set-up builds the model on the device with no initialisation, copies in
the benchmark's weights tensor by tensor (``lib/tensor_weights.py``, under
the published names, through the program's key map), makes a pool of
prompt batches on the device and decodes the first batch once (warm-up,
not counted). A prompt is left-padded: 4 text tokens, the image's
placeholders, 20 text tokens; the image's LM-input embeddings fill the
placeholders. A unit decodes one batch and copies its tokens and summed
log-probabilities to the host.

The check, after the window, holds the served path to the plain float32
reference (``reference/kimi_vl.py``) one layer at a time. The pool's
batch with the longest prompt is served once more through
``greedy_decode_cached``, its step graphs captured anew with taps
(``Taps``): forward pre-hooks that copy, for ``check_captions`` rows of
the batch (the longest prompt and a draw from the seed), each layer's
input, the experts the program's router picks (``ops/moe.py::route`` on
the MoE's own input, as the MoE calls it) and the final residual, at every
slot, in the prefill and inside the replayed steps. Then the reference
runs each layer on the program's own input of that layer, for every
tapped token: its causal attention over the row's earlier tokens, its
RMSNorm and router in float32, and the routed sum over the experts the
program picked. Four numbers:
  * ``layer_gap``: over the layers (the embedding lookup counted as one),
    the worst ||program's output - reference's output|| / ||reference's
    output - input||, summed over the tapped tokens;
  * ``route_differs``: over the MoE layers, the worst share of tapped
    tokens whose set of experts differs from the reference's pick;
  * ``token_gap``: the head on the program's final residual: the widest
    gap, over every served position, by which the served token's logit
    lies below the reference's best;
  * ``logprob_gap``: the widest gap between a caption's summed
    log-probability as the program returned it and as the reference's head
    scores the same tokens.
On standard error, not a limit: the tapped batch's rows whose tokens
differ from the same batch's in the window.

Controls (``control``): the reference with the operands and results of
its routed experts' GEMMs and of the head's in float8 e4m3, one precision
below bf16 (``layer_gap``, ``token_gap``, ``logprob_gap``); the
reference's router without the correction bias, a router fault
(``route_differs``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from h100_bench.lib import tensor_weights as TW
from h100_bench.lib import vlm_bounds
from h100_bench.lib.inputs import S_SAMPLE, S_TENSORS
from h100_bench.lib.trace import span
from h100_bench.lib.traffic import generator, lengths
from h100_bench.reference import kimi_vl as ref
from h100_bench.reference.precision import Precision

S_IMAGES = 21  # the image-token multiset's order
STD = 0.02  # matrices, image embeddings
BIAS_STD = 0.02  # the experts' correction bias
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weight_draws(c: dict, seed: int, device, names=None):
    """(name, tensor) of the benchmark's weights under the published names
    (``configs/<config>.json``, ``assumed``), or of ``names`` only."""
    return TW.tensors(ref.spec(c), seed, device, DTYPES[c["compute_dtype"]], STD, BIAS_STD,
                      names)


def batches(c: dict, tr: dict, seed: int, device) -> list:
    """``pool_batches`` prompt batches: ``ids`` / ``mask`` (B, P) left-padded
    to the pool's longest prompt, ``image`` (placeholders, hidden) in the
    model's dtype, and on the host each row's prompt length and image rows."""
    b, n = tr["batch"], tr["pool_batches"]
    before, after = tr["text_before_image"], tr["text_after_image"]
    ph = c["media_placeholder_token_id"]
    n_img = lengths(tr["image_tokens"], b * n, seed, S_IMAGES)
    p = int(n_img.max()) + before + after  # one width for every batch: the warm-up's shapes
    gen = generator(seed, S_TENSORS, device)
    out = []
    for i in range(n):
        img = n_img[i * b:(i + 1) * b]
        plen = img + before + after
        start = torch.as_tensor(p - plen, device=device)[:, None]
        n_dev = torch.as_tensor(img, device=device)[:, None]
        rel = torch.arange(p, device=device)[None, :] - start
        words = torch.randint(0, ph, (b, p), generator=gen, device=device)
        is_img = (rel >= before) & (rel < before + n_dev)
        ids = torch.where(rel < 0, 0, torch.where(is_img, ph, words))
        image = (torch.randn(int(img.sum()), c["hidden_size"], generator=gen, device=device)
                 * STD).to(DTYPES[c["compute_dtype"]])
        out.append({"ids": ids, "mask": (rel >= 0).long(), "image": image, "prompt": plen,
                    "image_rows": np.concatenate([[0], np.cumsum(img)])})
    return out


def port_model(c: dict, seed: int, device):
    from aladin_torch.models import kimi_vl

    cfg = kimi_vl.KimiVLConfig.from_dict(dict(c, dtype=c["compute_dtype"]))
    with torch.device("meta"):
        model = kimi_vl.KimiVLForCausalLM(cfg)
    model.to_empty(device=device)
    assert kimi_vl.load_published(model, weight_draws(c, seed, device)) == len(ref.spec(c))
    return model.eval()


class Taps:
    """Forward pre-hooks on ``model`` that copy what it computes for
    ``rows`` of a batch into buffers by cache slot: ``x`` (layers + 1, n,
    T, hidden), each layer's input and, last, the final residual (the
    prefill's last slot and the steps' slots only); ``experts`` (layers, n,
    T, k), the experts each MoE layer's router picks. A prefill chunk is
    recognised by its 3-d input, a cached step by its one row a sequence;
    a step's slot is counted on the device (``slot``, reset by the
    prefill), so the copies run inside the captured step graphs."""

    def __init__(self, model, rows, slots: int, device):
        from aladin_torch.ops import moe

        cfg, self.model, self.moe = model.cfg, model, moe
        n, layers = len(rows), cfg.num_hidden_layers
        self.rows = list(rows)
        self.rows_dev = torch.as_tensor(self.rows, device=device)
        self.x = torch.zeros(layers + 1, n, slots, cfg.hidden_size,
                             dtype=model.language_model.lm_head.weight.dtype, device=device)
        self.experts = torch.full((layers, n, slots, cfg.num_experts_per_tok), -1,
                                  dtype=torch.long, device=device)
        self.slot = torch.zeros(1, dtype=torch.long, device=device)
        self.next_row, self.lo, self.width, self.prefill = 0, 0, 0, False
        self.handles = []
        for i, layer in enumerate(model.layers):
            self.handles.append(layer.input_layernorm.register_forward_pre_hook(
                lambda mod, args, i=i: self._layer_input(i, args[0])))
            if not layer.dense:
                self.handles.append(layer.mlp.register_forward_pre_hook(
                    lambda mod, args, i=i: self._route(i, mod, args[0])))
        self.handles.append(model.language_model.model.norm.register_forward_pre_hook(
            lambda mod, args: self._put(self.x[layers], args[0])))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def _put(self, buf: torch.Tensor, v: torch.Tensor) -> None:
        """``v``: a prefill chunk's (rows, P, ...) or, at a step (or the
        prefill's last position), (B, ...) rows."""
        if v.dim() == buf.dim():  # (rows, P, ...): a prefill chunk
            for k, r in enumerate(self.rows):
                if self.lo <= r < self.lo + v.shape[0]:
                    buf[k, :v.shape[1]] = v[r - self.lo]
        elif self.prefill:  # the final residual of the prompts' last position
            buf[:, self.width - 1] = v.index_select(0, self.rows_dev)
        else:
            buf.index_copy_(1, self.slot, v.index_select(0, self.rows_dev)[:, None])

    def _layer_input(self, i: int, x: torch.Tensor) -> None:
        if i == 0:
            self.prefill = x.dim() == 3
            if self.prefill:
                self.lo, self.width = self.next_row, x.shape[1]
                self.next_row += x.shape[0]
                self.slot.fill_(self.width - 1)
            else:
                self.slot += 1
        self._put(self.x[i], x)

    def _route(self, i: int, mod, h: torch.Tensor) -> None:
        c = self.model.cfg
        picked = self.moe.route(h.reshape(-1, h.shape[-1]), mod.gate.weight,
                                mod.gate.e_score_correction_bias, c.num_experts_per_tok,
                                c.routed_scaling_factor)[1]
        self._put(self.experts[i], picked.reshape(*h.shape[:-1], -1))


class Recaptioning:
    def __init__(self, ctx):
        from aladin_torch.tasks import decode_cache

        c, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx, self.dc = ctx, decode_cache
        self.model = port_model(c, ctx.seed, dev)
        self.pool = batches(c, tr, ctx.seed, dev)
        self.prompts = [b["prompt"] for b in self.pool]
        self._decode(self.pool[0])
        self.served, self.next = [], 0

    def _decode(self, b):
        return self.dc.greedy_decode_cached(self.model, b["ids"], b["image"], b["mask"],
                                            max_steps=self.ctx.traffic["new_tokens"])

    def unit(self) -> int:
        i = self.next % len(self.pool)
        with span("vlm.batch"):
            tokens, logprob = self._decode(self.pool[i])
            tokens, logprob = tokens.cpu(), logprob.cpu()
        self.served.append((i, tokens, logprob))
        self.next += 1
        return tokens.shape[0]

    def drain(self) -> None:
        pass

    def counters(self) -> dict:
        c, tr = self.ctx.config, self.ctx.traffic
        new = tr["new_tokens"]
        flops = bound = 0.0
        for i, _, _ in self.served:
            prompt = self.prompts[i]
            flops += sum(vlm_bounds.sequence_flops(c, int(p), new) for p in prompt)
            bound += vlm_bounds.prefill_expert_bound_s(c, int(prompt.sum()))
        moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
        return {"model_flops": flops, "prefill_expert_bound_s": bound, "vlm_config": c,
                "step_calls": len(self.served) * (new - 1) * moe_layers,
                "step_batch": tr["batch"]}

    def failed(self) -> int:
        return sum(int((~torch.isfinite(lp)).sum()) for _, _, lp in self.served)

    def tapped_rows(self):
        """(batch index, rows) that the check taps: the pool's batch with
        the longest prompt, that row first, then a draw from the seed."""
        i = max(range(len(self.prompts)), key=lambda j: int(self.prompts[j].max()))
        longest = int(self.prompts[i].argmax())
        n = min(self.ctx.traffic["check_captions"], len(self.prompts[i]))
        perm = torch.randperm(len(self.prompts[i]), generator=generator(self.ctx.seed, S_SAMPLE))
        return i, [longest] + [int(r) for r in perm if int(r) != longest][:n - 1]

    def release(self) -> None:
        """Serve the tapped batch again under ``Taps``, then drop the model."""
        from aladin_torch.tasks import decode_latent

        i, rows = self.tapped_rows()
        b = self.pool[i]
        slots = decode_latent.cache_slots(b["ids"].shape[1], self.ctx.traffic["new_tokens"])
        decode_latent.release_graphs(self.model)  # the next capture records the taps' copies
        taps = Taps(self.model, rows, slots, self.ctx.device)
        try:
            tokens, logprob = self._decode(b)
        finally:
            taps.remove()
            decode_latent.release_graphs(self.model)
        self.tapped = {"batch": i, "rows": rows, "x": taps.x, "experts": taps.experts,
                       "tokens": tokens[rows], "logprob": logprob[rows].float()}
        window = [t for j, t, _ in self.served if j == i]
        if window:
            differ = int((window[-1][rows] != tokens[rows].cpu()).any(dim=1).sum())
            print(f"tapped rows whose tokens differ from the window's: {differ} of {len(rows)} "
                  f"(not a limit)", file=sys.stderr)
        self.model = None

    def check(self):
        return self._compare()

    @torch.no_grad()
    def _compare(self, prec: Precision = Precision("f32"), correction: bool = True):
        """The check's numbers (module doc) of the reference in ``prec``,
        routing with (``correction``) or without its correction bias."""
        ctx, c, t = self.ctx, self.ctx.config, self.tapped
        b = self.pool[t["batch"]]
        width, new = b["ids"].shape[1], ctx.traffic["new_tokens"]
        end = width + new - 1  # the slots past the last fed token
        layers = c["num_hidden_layers"]

        def weights(names):
            return {n: x.float() for n, x in weight_draws(c, ctx.seed, ctx.device, names)}

        rows = []
        for k, r in enumerate(t["rows"]):
            p = int(b["prompt"][r])
            img = b["image"][int(b["image_rows"][r]):int(b["image_rows"][r + 1])]
            ids = torch.cat([b["ids"][r, width - p:], t["tokens"][k, :-1]])
            rows.append({"k": k, "start": width - p, "ids": ids, "image": img, "prompt": p})

        def tapped(buf, i, first=None):
            """Row by row, ``buf[i]`` from the row's first slot (or ``first``)
            to its last fed token's."""
            return [buf[i, q["k"], q["start"] if first is None else first:end] for q in rows]

        def gap(got, want, base):
            num = sum(float((g.float() - w).pow(2).sum()) for g, w in zip(got, want))
            den = sum(float((w - x).pow(2).sum()) for w, x in zip(want, base))
            return (num / max(den, 1e-30)) ** 0.5

        with prec.context():
            W = weights([ref.BODY + "embed_tokens.weight"])
            want = [ref.embed(W, c, q) for q in rows]
            del W
            layer_gap = gap(tapped(t["x"], 0), want, [torch.zeros_like(w) for w in want])
            route_differs = 0.0
            for i in range(layers):
                xs = [x.float() for x in tapped(t["x"], i)]
                chosen = None
                if i >= c["first_k_dense_replace"]:
                    chosen = torch.cat(tapped(t["experts"], i))
                    if bool((chosen < 0).any()):
                        raise RuntimeError(f"layer {i}: a tapped token has no routing")
                W = weights([n for n, _ in ref.layer_spec(c, i)])
                ys, picked = ref.layers(W, i, c, xs, prec, chosen, correction)
                del W
                if i + 1 < layers:
                    got, want, base = tapped(t["x"], i + 1), ys, xs
                else:  # the final residual is tapped at the served positions only
                    got = tapped(t["x"], layers, width - 1)
                    want = [y[width - 1 - q["start"]:] for y, q in zip(ys, rows)]
                    base = [x[width - 1 - q["start"]:] for x, q in zip(xs, rows)]
                layer_gap = max(layer_gap, gap(got, want, base))
                if picked is not None:
                    same = (picked.sort(dim=1).values == chosen.sort(dim=1).values).all(dim=1)
                    route_differs = max(route_differs, float((~same).float().mean()))
            W = weights([ref.BODY + "norm.weight", ref.LM + "lm_head.weight"])
            token_gap = logprob_gap = 0.0
            for q, final in zip(rows, tapped(t["x"], layers, width - 1)):
                logits = ref.head(W, c, final.float(), prec)
                served = t["tokens"][q["k"]][:, None]
                below = logits.amax(dim=-1, keepdim=True) - logits.gather(1, served)
                token_gap = max(token_gap, float(below.max()))
                want_lp = float(torch.log_softmax(logits, dim=-1).gather(1, served).sum())
                logprob_gap = max(logprob_gap, abs(want_lp - float(t["logprob"][q["k"]])))
            del W
        limits = ctx.traffic["limits"]
        return [("layer_gap", layer_gap, limits["layer_gap"]),
                ("route_differs", route_differs, limits["route_differs"]),
                ("token_gap", token_gap, limits["token_gap"]),
                ("logprob_gap", logprob_gap, limits["logprob_gap"])]


def control(work: Recaptioning) -> dict:
    """Readings of the controls on the same taps: the reference with its
    routed experts' and its head's GEMM operands and results in float8
    e4m3, and the reference routing without its correction bias."""
    return {"fp8_experts": work._compare(Precision("fp8")),
            "router_without_bias": work._compare(correction=False)}


def setup(ctx) -> Recaptioning:
    return Recaptioning(ctx)
