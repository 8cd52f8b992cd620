"""Document condensing with Kimi-Linear: the port's cached greedy decoder,
``tasks/decode_cache.py::greedy_decode_cached`` (which hands a hybrid-cache
model to ``tasks/decode_hybrid.py``), in bf16 on one card's share of an
EP-4 deployment (64 of the 256 experts of each MoE layer), on batches of
documents one after another.

Set-up builds the model on the device, copies in
the benchmark's weights tensor by tensor (``weight_draws``, each tensor
from its own stream of the seed, under the port's names), makes a pool of
document batches on the device and warms up on the first batch: it is
served through ``greedy_decode_cached`` with taps (below), then the step
graphs are captured anew without them (``decode_hybrid.capture_steps``),
so the window replays untapped graphs and nothing is captured in it. A
batch is 64 documents packed end to end: the lengths are the traffic's
fixed multiset in an order drawn from the seed, each document followed by
the run's 24 instruction tokens. A unit decodes one batch and copies its
tokens and summed log-probabilities to the host.

The check, after the window, holds the served path to the plain float32
reference (``reference/kimi_linear.py``) one layer at a time, as
``runners/vlm_caption.py`` does for Kimi-VL. The warm-up's taps
(``Taps``) are forward pre-hooks whose copies run inside the captured
step graphs too: for ``check_documents`` documents of the batch (the
longest and a draw from the seed), each layer's input and the final
residual at every token, in the prefill and the steps, and the experts the
program's router picks; after the last step the documents' KDA states are
copied from the decode cache. All of it waits on the host through the
window. Then the reference runs each layer on the program's own input of
that layer over each tapped document's whole sequence (prompt and fed
tokens). Five numbers:
  * ``layer_gap``, ``route_differs``, ``token_gap``, ``logprob_gap``: as
    Kimi-VL's (``runners/vlm_caption.py``), over the 27 layers and the
    128 served positions of each tapped document;
  * ``state_gap``: over the KDA layers, the worst ||program's state -
    reference's|| / ||reference's||, the tapped documents' states after the
    last fed token, summed.

Controls (``control``): the reference with every GEMM's operands and
results in float8 e4m3, one precision below bf16; the reference with the
KDA state held in bf16, one precision below the stated float32.
"""

from __future__ import annotations

import math
import sys
import time
from statistics import NormalDist

import numpy as np
import torch

from h100_bench.lib import kda_bounds
from h100_bench.lib.inputs import S_SAMPLE, S_TENSORS
from h100_bench.lib.tensor_weights import STREAM0
from h100_bench.lib.trace import span
from h100_bench.lib.traffic import generator, permutation
from h100_bench.reference import kimi_linear as ref
from h100_bench.reference.precision import Precision

S_DOCS = 22  # the document-length multiset's order
STD = 0.02  # matrices
BIAS_STD = 0.02  # the experts' correction bias
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def weight_draws(c: dict, seed: int, device, names=None):
    """(name, tensor) of the benchmark's weights (``configs/<config>.json``,
    ``assumed``), or of ``names`` only, each drawn on its own from stream
    ``STREAM0 + i`` of the seed (``lib/tensor_weights.py``'s convention):
    matrices normal(0, 0.02) in the model's dtype, the correction bias
    normal(0, 0.02), ``A_log`` log U(1, 16) and ``dt_bias`` softplus^-1 of a
    log-uniform dt in [1e-3, 1e-1] in float32, the convolutions' kernels
    U(-1/2, 1/2), ``b_g`` zero, norm scales one."""
    dtype = DTYPES[c["compute_dtype"]]
    wanted = None if names is None else set(names)
    for i, (name, shape) in enumerate(ref.spec(c)):
        if wanted is not None and name not in wanted:
            continue
        gen = generator(seed, STREAM0 + i, device)
        if name.endswith("A_log"):
            yield name, torch.log(1.0 + 15.0 * torch.rand(shape, generator=gen, device=device))
        elif name.endswith("dt_bias"):
            u = torch.rand(shape, generator=gen, device=device)
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            yield name, dt + torch.log(-torch.expm1(-dt))
        elif "_conv1d." in name:
            yield name, (torch.rand(shape, generator=gen, device=device) - 0.5).to(dtype)
        elif name.endswith("g_b_proj.bias"):
            yield name, torch.zeros(shape, device=device, dtype=dtype)
        elif len(shape) < 2 and not name.endswith("correction_bias"):
            yield name, torch.ones(shape, device=device, dtype=dtype)
        else:
            std = STD if len(shape) >= 2 else BIAS_STD
            yield name, (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def document_lengths(spec: dict, n: int) -> np.ndarray:
    """The ``n`` quantiles at (i + 1/2) / n of a lognormal of the given
    median and sigma, rounded and clipped, ascending."""
    q = spec["lognormal_quantiles"]
    nd = NormalDist()
    return np.array([min(q["max"], max(q["min"], round(
        q["median"] * math.exp(q["sigma"] * nd.inv_cdf((i + 0.5) / n))))) for i in range(n)],
        np.int64)


def batches(c: dict, tr: dict, seed: int, device) -> list:
    """``pool_batches`` batches: ``ids`` (N,) the prompts packed end to end
    on the device and ``lengths`` (B,) on the host; a prompt is a document
    and the run's instruction."""
    b, n = tr["batch"], tr["pool_batches"]
    multiset = document_lengths(tr["document_tokens"], b)
    gen = generator(seed, S_TENSORS, device)
    special = tr["special_ids_from"]
    instruction = torch.randint(0, special, (tr["instruction_tokens"],), generator=gen,
                                device=device)
    out = []
    for i in range(n):
        docs = multiset[permutation(b, seed, S_DOCS + i)]
        words = torch.randint(0, special, (int(docs.sum()),), generator=gen, device=device)
        ids = torch.cat([x for d in words.split(docs.tolist()) for x in (d, instruction)])
        out.append({"ids": ids, "lengths": docs + tr["instruction_tokens"]})
    return out


def port_model(c: dict, seed: int, device):
    from aladin_torch.models import kimi_linear

    cfg = kimi_linear.KimiLinearConfig.from_dict(dict(c, dtype=c["compute_dtype"]))
    # built on the device itself: a fresh process spent ~7 s building its
    # first model on the meta device (measured on an H100 machine's host)
    with torch.device(device):
        model = kimi_linear.KimiLinearForCausalLM(cfg)
    assert kimi_linear.load_named(model, weight_draws(c, seed, device)) == len(ref.spec(c))
    return model.eval()


class Taps:
    """Forward pre-hooks on ``model`` that copy what it computes for the
    documents ``rows`` of a batch of ``lengths`` into buffers by token:
    ``x`` (layers + 1, R, hidden), each layer's input and, last, the final
    residual (at the served positions only); ``experts`` (layers, R, k),
    the experts each MoE layer's router picks. Document r's tokens (its
    prompt, then the fed tokens) lie at rows [off_r, off_r + length_r +
    new - 1). The prefill is recognised by its packed rows at layer 0; a
    step's index is counted on the device, so the copies run inside the
    captured step graphs."""

    def __init__(self, model, rows, lengths, new: int, device):
        from aladin_torch.ops import moe

        cfg, self.model, self.moe = model.cfg, model, moe
        layers = cfg.num_hidden_layers
        lengths = [int(n) for n in lengths]
        self.rows = list(rows)
        self.n_tokens = sum(lengths)
        cu = np.concatenate([[0], np.cumsum(lengths)])
        size = [lengths[r] + new - 1 for r in self.rows]
        self.off = np.concatenate([[0], np.cumsum(size)])
        src = np.concatenate([np.arange(cu[r], cu[r + 1]) for r in self.rows])
        dst = np.concatenate([np.arange(self.off[k], self.off[k] + lengths[r])
                              for k, r in enumerate(self.rows)])
        self.src_host, self.dst_host = src, dst
        self.src = torch.as_tensor(src, device=device)
        self.dst = torch.as_tensor(dst, device=device)
        self.rows_dev = torch.as_tensor(self.rows, device=device)
        self.last = torch.as_tensor([self.off[k] + lengths[r] - 1
                                     for k, r in enumerate(self.rows)], device=device)
        dtype = model.lm_head.weight.dtype
        self.x = torch.zeros(layers + 1, int(self.off[-1]), cfg.hidden_size, dtype=dtype,
                             device=device)
        self.experts = torch.full((layers, int(self.off[-1]), cfg.num_experts_per_token), -1,
                                  dtype=torch.long, device=device)
        self.j = torch.zeros(1, dtype=torch.long, device=device)
        self.prefill, self.seen = False, 0
        self.handles = []
        for i, layer in enumerate(model.layers):
            self.handles.append(layer.input_layernorm.register_forward_pre_hook(
                lambda mod, args, i=i: self._layer_input(i, args[0])))
            if not layer.dense:
                self.handles.append(layer.mlp.register_forward_pre_hook(
                    lambda mod, args, i=i: self._route(i, mod, args[0])))
        self.handles.append(model.model.norm.register_forward_pre_hook(
            lambda mod, args: self._final(args[0])))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def _step_rows(self) -> torch.Tensor:
        """The buffer rows of the token a step feeds (the prefill's last
        prompt token at j = -1)."""
        return self.last + 1 + self.j

    def _layer_input(self, i: int, x: torch.Tensor) -> None:
        if i == 0:
            self.prefill = x.shape[0] == self.n_tokens
            if self.prefill:
                self.j.fill_(-1)
            else:
                self.j += 1
        self.seen = 0
        if self.prefill:
            self.x[i].index_copy_(0, self.dst, x.index_select(0, self.src))
        else:
            self.x[i].index_copy_(0, self._step_rows(), x.index_select(0, self.rows_dev))

    def _route(self, i: int, mod, h: torch.Tensor) -> None:
        c = self.model.cfg
        picked = self.moe.route(h, mod.gate.weight, mod.gate.e_score_correction_bias,
                                c.num_experts_per_token, c.routed_scaling_factor)[1]
        if not self.prefill:
            self.experts[i].index_copy_(0, self._step_rows(), picked.index_select(0, self.rows_dev))
            return
        lo, hi = self.seen, self.seen + h.shape[0]
        self.seen = hi
        sel = np.nonzero((self.src_host >= lo) & (self.src_host < hi))[0]
        if len(sel):
            src = torch.as_tensor(self.src_host[sel] - lo, device=h.device)
            dst = torch.as_tensor(self.dst_host[sel], device=h.device)
            self.experts[i].index_copy_(0, dst, picked.index_select(0, src))

    def _final(self, x: torch.Tensor) -> None:
        """(B, hidden): the prompts' last positions in the prefill, the fed
        tokens' at a step."""
        rows = self.last if self.prefill else self._step_rows()
        self.x[-1].index_copy_(0, rows, x.index_select(0, self.rows_dev))


class Condensing:
    def __init__(self, ctx):
        from aladin_torch.tasks import decode_cache
        from aladin_torch.utils import profiling

        c, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx, self.dc, self.profiling = ctx, decode_cache, profiling
        t0 = time.perf_counter()
        self.model = port_model(c, ctx.seed, dev)
        _sync(dev)
        t1 = time.perf_counter()
        self.pool = batches(c, tr, ctx.seed, dev)
        _sync(dev)
        t2 = time.perf_counter()
        self._serve_tapped()
        _sync(dev)
        note(f"set-up: weights {t1 - t0:.2f} s, pool {t2 - t1:.2f} s, tapped warm-up batch "
             f"and capture {time.perf_counter() - t2:.2f} s")
        self.served, self.next = [], 0

    def _decode(self, b):
        return self.dc.greedy_decode_cached(self.model, b["ids"], b["lengths"],
                                            max_steps=self.ctx.traffic["new_tokens"])

    def unit(self) -> int:
        i = self.next % len(self.pool)
        before = self.profiling.counters()["moe.held_pairs"]
        with span("vlm.batch"):
            tokens, logprob = self._decode(self.pool[i])
            tokens, logprob = tokens.cpu(), logprob.cpu()
        pairs = self.profiling.counters()["moe.held_pairs"] - before
        self.served.append((i, tokens, logprob, pairs))
        self.next += 1
        return tokens.shape[0]

    def drain(self) -> None:
        pass

    def counters(self) -> dict:
        c, tr = self.ctx.config, self.ctx.traffic
        new = tr["new_tokens"]
        n_kda = kda_bounds.layer_kinds(c)[0]
        flops = k5 = k6 = 0.0
        for i, _, _, pairs in self.served:
            lengths = self.pool[i]["lengths"]
            flops += kda_bounds.model_flops(c, [int(n) for n in lengths], new, pairs)
            k5 += n_kda * kda_bounds.k5_bound_s(c, int(lengths.sum()), len(lengths))
            k6 += n_kda * (new - 1) * kda_bounds.k6_bound_s(c, len(lengths))
        return {"model_flops": flops, "k5_bound_s": k5, "k6_bound_s": k6}

    def failed(self) -> int:
        return sum(int((~torch.isfinite(lp)).sum()) for _, _, lp, _ in self.served)

    def tapped_rows(self):
        """The documents of the pool's first batch that the check taps: the
        longest first, then a draw from the seed."""
        lengths = self.pool[0]["lengths"]
        longest = int(np.argmax(lengths))
        n = min(self.ctx.traffic["check_documents"], len(lengths))
        perm = torch.randperm(len(lengths), generator=generator(self.ctx.seed, S_SAMPLE))
        return [longest] + [int(r) for r in perm if int(r) != longest][:n - 1]

    def _serve_tapped(self) -> None:
        """The warm-up (module doc): serve the pool's first batch under
        ``Taps``, keep the tapped documents' copies and KDA states on the
        host, then capture the window's step graphs without the taps."""
        from aladin_torch.tasks import decode_hybrid, decode_latent

        rows, b, new = self.tapped_rows(), self.pool[0], self.ctx.traffic["new_tokens"]
        taps = Taps(self.model, rows, b["lengths"], new, self.ctx.device)
        try:
            tokens, logprob = self._decode(b)
            # the program holds each state transposed (ops/kernels/kda.py)
            states = decode_hybrid.held_state(self.model).kda[:, taps.rows_dev].transpose(-1, -2)
            states = states.contiguous()
        finally:
            taps.remove()
            decode_latent.release_graphs(self.model)  # their captures hold the taps' copies
        self.tapped = {"rows": rows, "off": taps.off, "x": taps.x.cpu(),
                       "experts": taps.experts.cpu(), "states": states.cpu(),
                       "tokens": tokens[rows].cpu(), "logprob": logprob[rows].float().cpu()}
        del taps, states
        decode_hybrid.capture_steps(self.model, b["lengths"], new, self.ctx.device)
        if self.ctx.device.type == "cuda":
            # the peak the run reports is then the window's: the taps'
            # buffers are the check's, not what a deployment holds
            torch.cuda.reset_peak_memory_stats(self.ctx.device)

    def release(self) -> None:
        """Drop the model; the check reads the warm-up's taps."""
        rows = self.tapped["rows"]
        window = [t for j, t, _, _ in self.served if j == 0]
        if window:
            differ = int((window[-1][rows] != self.tapped["tokens"]).any(dim=1).sum())
            note(f"tapped documents whose tokens differ from the window's: {differ} of "
                 f"{len(rows)} (not a limit)")
        self.model = None
        _sync(self.ctx.device)

    def check(self):
        t0 = time.perf_counter()
        out = self._compare()
        note(f"check: the reference in {time.perf_counter() - t0:.2f} s")
        return out

    @torch.no_grad()
    def _compare(self, prec: Precision = Precision("f32"),
                 state_dtype: torch.dtype = torch.float32):
        """The check's numbers (module doc) of the reference in ``prec``,
        with the KDA state held in ``state_dtype``."""
        ctx, c = self.ctx, self.ctx.config
        t = {k: v.to(ctx.device) if torch.is_tensor(v) else v for k, v in self.tapped.items()}
        b, new = self.pool[0], ctx.traffic["new_tokens"]
        layers = c["num_hidden_layers"]
        cu = np.concatenate([[0], np.cumsum(b["lengths"])])

        spent = {"weights": 0.0, "kda": 0.0, "mla": 0.0}

        def weights(names):
            t0 = time.perf_counter()
            out = {n: x.float() for n, x in weight_draws(c, ctx.seed, ctx.device, names)}
            _sync(ctx.device)
            spent["weights"] += time.perf_counter() - t0
            return out

        spans = [(int(t["off"][k]), int(t["off"][k + 1])) for k in range(len(t["rows"]))]
        plen = [int(b["lengths"][r]) for r in t["rows"]]

        def tapped(i, served=False):
            """Each document's rows of ``x[i]`` (from its last prompt token
            on with ``served``)."""
            return [t["x"][i, lo + (p - 1 if served else 0):hi] for (lo, hi), p in zip(spans, plen)]

        def gap(got, want, base):
            num = sum(float((g.float() - w).pow(2).sum()) for g, w in zip(got, want))
            den = sum(float((w - x).pow(2).sum()) for w, x in zip(want, base))
            return (num / max(den, 1e-30)) ** 0.5

        with prec.context():
            W = weights([ref.BODY + "embed_tokens.weight"])
            ids = [torch.cat([b["ids"][cu[r]:cu[r + 1]], t["tokens"][k, :-1]])
                   for k, r in enumerate(t["rows"])]
            want = [ref.embed(W, s) for s in ids]
            del W
            layer_gap = gap(tapped(0), want, [torch.zeros_like(w) for w in want])
            route_differs = state_gap = 0.0
            for i in range(layers):
                xs = [x.float() for x in tapped(i)]
                chosen = None
                if i >= c["first_k_dense_replace"]:
                    chosen = torch.cat([t["experts"][i, lo:hi] for lo, hi in spans])
                    if bool((chosen < 0).any()):
                        raise RuntimeError(f"layer {i}: a tapped token has no routing")
                W = weights([n for n, _ in ref.layer_spec(c, i)])
                t0 = time.perf_counter()
                ys, picked, states = ref.layers(W, i, c, xs, prec, chosen,
                                                state_dtype=state_dtype)
                _sync(ctx.device)
                spent["kda" if ref.is_kda(c, i) else "mla"] += time.perf_counter() - t0
                del W
                if i + 1 < layers:
                    got, want, base = tapped(i + 1), ys, xs
                else:  # the final residual is tapped at the served positions only
                    got = tapped(layers, served=True)
                    want = [y[p - 1:] for y, p in zip(ys, plen)]
                    base = [x[p - 1:] for x, p in zip(xs, plen)]
                layer_gap = max(layer_gap, gap(got, want, base))
                if picked is not None:
                    same = (picked.sort(dim=1).values == chosen.sort(dim=1).values).all(dim=1)
                    route_differs = max(route_differs, float((~same).float().mean()))
                if states is not None:
                    k = sum(ref.is_kda(c, j) for j in range(i))
                    mine = t["states"][k].float()
                    state_gap = max(state_gap, float((mine - states).norm() / states.norm()))
            W = weights([ref.BODY + "norm.weight", "lm_head.weight"])
            token_gap = logprob_gap = 0.0
            for k, final in enumerate(tapped(layers, served=True)):
                logits = ref.head(W, c, final.float(), prec)
                served = t["tokens"][k][:, None]
                below = logits.amax(dim=-1, keepdim=True) - logits.gather(1, served)
                token_gap = max(token_gap, float(below.max()))
                want_lp = float(torch.log_softmax(logits, dim=-1).gather(1, served).sum())
                logprob_gap = max(logprob_gap, abs(want_lp - float(t["logprob"][k])))
            del W
        note("check: the reference's weight draws {weights:.2f} s, KDA layers {kda:.2f} s, "
             "MLA layers {mla:.2f} s".format(**spent))
        limits = ctx.traffic["limits"]
        return [("layer_gap", layer_gap, limits["layer_gap"]),
                ("route_differs", route_differs, limits["route_differs"]),
                ("token_gap", token_gap, limits["token_gap"]),
                ("logprob_gap", logprob_gap, limits["logprob_gap"]),
                ("state_gap", state_gap, limits["state_gap"])]


def note(text: str) -> None:
    print(text, file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def control(work: Condensing) -> dict:
    """Readings of the controls on the same taps: the reference with every
    GEMM in float8 e4m3, and with the KDA state held in bf16."""
    return {"fp8_gemms": work._compare(Precision("fp8")),
            "bf16_state": work._compare(state_dtype=torch.bfloat16)}


def setup(ctx) -> Condensing:
    return Condensing(ctx)
