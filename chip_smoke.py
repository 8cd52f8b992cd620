#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aladin_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. env    - torch/CUDA versions, the card's name and power limit, yaml.
  2. build  - every CUDA kernel built from the sources in this checkout
              with nvcc (sm_90a), one nvcc a source, all started together,
              and the seconds taken (the Triton kernel compiles at its
              first launch).
  3. k1     - the MrSw all-pairs kernel (csrc/mrsw_kernel.cu) against its
              plain PyTorch version on the card: bf16 and int8, plain and
              length-bucketed, at 1000 x 5000 pairs with uniform lengths and
              at the shapes the main path gives it; the zero-floor case; a
              score's independence of the corpus shape and bf16 bucketed
              scores equal to unbucketed ones bit for bit; then its time at
              the 5k x 25k benchmark shape beside both bounds (valid work,
              and the padded operands it multiplies), cuBLAS's product of
              the same operands, and the int8 bucketed scorer's pairs/s.
  4. main   - the serving path end to end at VinVL-base width (12 layers,
              hidden 768, 2054-d regions) on random weights from a seed:
              aladin_torch.cli.test over 1000 images / 5000 captions, with
              bf16 scoring, with int8 scoring, and with the int8 encoder
              (--int8_encoder, bf16 scoring). Each run must launch K1 and
              give finite metrics; the int8-encoder run must launch K4-dynx
              exactly 48 times an encode batch (12 layers x {QKV, FFN-up} x
              2 passes) and its scores correlate with the bf16 run's > 0.99.
              Each run must read through the native TSV reader and WordPiece
              tokenizer; the loader alone is timed through them and through
              the pure-Python ones, whose first 8 batches must be equal. A
              fourth run, bf16 with --ndcg over synthetic rougeL / spice
              relevance matrices (raw float32, 5000 x 1000, from a seed),
              must give NDCG@25 above 0 equal (1e-6) to a numpy NDCG written
              here over every query of its score matrix, and per query to
              the port's scorer for 50 seeded queries each way.
  5. encode_q8ln - eval.encode.encode_data over 1000 rows of that corpus
              with quant_matmuls + fused_layernorm: 48 K3b and 48 K4
              launches a batch, no K4-dynx or K3a, global embeddings within
              a median cosine of 0.99 of the --int8_encoder encode's; the
              card time of one encode batch's forward (both passes) for
              those two models and the bf16 one (torch.profiler).
  6. search - aladin_torch.cli.search over that corpus at full width (bf16
              encoder, a released-format checkpoint of the random weights):
              build, then query with three free-text captions (each must
              give the hits of --query_index on its caption row) and by-row
              queries both ways; curve --shortlists 10,25,50,100 per
              direction, whose matching-only and full-rerank rows must equal
              the R@K of brute-force rankings of the same tensors (an
              i2t full rerank that runs out of memory at query_chunk 64 is
              recorded and checked at query_chunk 8); serial per-query
              latency of the three modes at n_serial 64, shortlist 100,
              with the profiler's card time, beside the reference's 0.023 /
              0.098 s; batched queries/s over 5000 caption queries; build
              seconds (of which encode) and peak memory.
  7. streaming - eval.streaming on the card: (a) matching at 5000 x 25000,
              cap_block 4096, the ground truth equal to each caption's tile
              entry bit for bit and the ranks equal to those of the tiles'
              matrix, rank differences against the dense compute_recall
              product counted, R@K equal; (b) alignment through K1 at
              5000 x 25000 (R 34, W 50, bf16, cap_block 2048): ranks equal
              to K1's full matrix's, K1 launched once a tile and a
              ground-truth block (13 + 49); (c) compute_recall at 100000 x
              500000, past the dense limit: seconds and pairs/s.
  8. parallel - data parallelism on a one-rank NCCL process group (one
              card: the two-rank parity runs on gloo in
              tests/test_torch_parallel.py), the sharded entry points called
              directly (cli/common.py::maybe_create_mesh gives no mesh for
              one rank): sharded_mrsw_scores without the small-corpus
              fallback at 1000 x 5000 (R 34, W 50, D 768), bf16 bit for bit
              against mrsw_scores and int8 within INT8_RTOL, both against the
              plain version, K1 launched once a call; sharded_search against
              search on the serving index both ways; the mesh streaming sweeps
              against the solo ones at 5000 x 25000 (matching with a top-k;
              alignment through K1, 13 + 49 launches); the data-parallel
              step at B 128 with both kernel knobs, dropout 0, equal to the
              plain step bit for bit over 2 steps, and a CUDA graph of 8
              data-parallel steps with the NCCL collectives captured equal to
              8 eager ones; cli/train for one epoch under the group. Host
              ms of each part beside the card's name and power limit.
  9. k2     - the fused attention kernels (csrc/attention_kernel.cu, the
              bf16 tensor-core forward and backward) against their plain
              versions at B 128, 12 heads of 64, bf16: the training path's
              S 50 and 84 and the ragged S 134 and 160 (MAX_SEQ), both bias
              shapes, dropout 0 and 0.1, a fully padded row; then kernel,
              plain and scaled_dot_product_attention times at S 50 and 84,
              each kernel time with its share of the bound; then the
              2-D path (bias_q == S) against the plain versions at B 32 and
              the odd S 17 and 121 under random 2-D masks, dropout 0 and
              0.1; then the captioning step's shape, B 32 S 120, and the
              decoder's, B 16 S 120, under per-row 2-D block masks: forward
              and backward against the plain versions, and kernel (also at
              dropout 0), plain and SDPA (the same float mask) times beside
              the bound.
  10. k3     - K3a: the fused residual+LayerNorm Triton forward and its
              backward kernel (csrc/layernorm_kernel.cu) against the plain
              versions at M = 128 x 84 and 128 x 50 rows of 768, the
              backward also against autograd through the plain forward, and
              its dgamma / dbeta bitwise equal over two calls; kernel, plain
              and library times (F.layer_norm, and autograd.grad through it
              for the backward) beside each bound.
  11. k4    - the W8A8 GEMM (csrc/quant_matmul.cu) on int8 x and on bf16 x
              through the dynx quantize kernel, against the plain versions
              at M 2688 / 1600 / 7 / 37, K 768, N 2304 and 3072, no
              activation / gelu / gelu_tanh, bf16 and f32 out (f32 without
              activation bitwise), the quantize bitwise; then kernel, plain,
              torch._int_mm and bf16 F.linear times at M 2688 and 1600, the
              quantize pass alone, and the card's SM clock and power draw
              sampled meanwhile.
  12. k3b   - the q8 residual LayerNorm (csrc/layernorm_kernel.cu) against
              its plain version at M 2688 and 1600 rows of 768; kernel, plain
              and unfused F.layer_norm + quantize times.
  13. train_fused - the train step (train.step.make_train_step) on the
              flagship recipe at VinVL-base width, B 128, with
              fused_attention and fused_layernorm on, as
              benchmarks/train_bench.py runs it: a few steps at dropout 0.1
              that must launch K2 and K3a's forward and backward kernels
              (and never the backward's torch ops); then one step at
              dropout 0 from the same params and batch with the knobs on
              and off, whose loss and grad_norm must agree; the step times.
  14. train_graph - --steps_per_dispatch's CUDA graph: the flagship step
              at VinVL-base width with fused_attention and fused_layernorm,
              at bs 32 and B 128 on random batches on the card: one graphed
              window of 8 steps against 8 eager steps from the same state at
              dropout 0, bit for bit (at B 128 also with the token-type
              table frozen, the check kept from when its gradient was an
              atomic sum, and the full step's graphed metrics within 1e-2
              relative besides bit for bit), host-clock ms a
              step over 4 windows each, the profiler's card ms, busy share
              and kernels a step by name (24 K2 forwards, 24 backwards, 48
              K3a forwards and 48 backwards), peak memory; at bs 32 and
              dropout 0.1, two replays draw other K2 seeds and the graphed
              losses equal the eager ones from one CUDA generator state.
  15. train_cli - aladin_torch.cli.train, the flagship recipe, one epoch at
              bs 32 over a synthetic corpus of 200 images with the
              VinVL-base-shaped random backbone: finite losses, validation
              launching K1, and a checkpoint that loads back; then with K2
              and K3a on, one epoch at K 1 and one at --steps_per_dispatch 8
              with --profile_dir, whose checkpoint loads back, whose
              trace names the K2 and K3a kernels, and whose steps, last
              metrics and best rsum equal the K 1 run's. The first epoch
              runs with --ndcg over synthetic minival relevances and must
              write model_best_ndcgspice.pth.tar.
  16. train_levers - the memory levers on the flagship step at VinVL-base
              width with K2 and K3a, on random batches on the card: (a) bs
              32, dropout 0.1, remat against no remat from one state and
              one CUDA generator state, loss and parameters bit for bit,
              24 -> 48 K2 and 48 -> 96 K3a forwards (backwards 24 / 48),
              and the alignment head in chunks of 8 captions
              (alignment-chunk) within 1e-3 of the unchunked loss;
              (b) B 512, dropout 0, no lever / remat / encoder-microbatch
              128 / both: peak memory, host and card ms a step, launches;
              remat's first loss equal to the no-lever one bit for bit,
              the micro-batched ones within 1e-3, remat's peak below the
              no-lever peak; (c) a CUDA graph of 8 remat steps, and of
              remat with micro-batches of 16, against 8 eager steps at bs
              32, bit for bit.
  17. variants - the model variants at VinVL-base width, bs 32, knobs on:
              alignment-side gated depth aggregation with the feature
              fusion, matching-side transformer aggregation with post-layers
              1, matching-side mean, teran-layers 2 shared, and separate
              with freeze-teran. Each: a step with the knobs against the
              same weights without them at dropout 0 (train_fused's
              tolerances), then steps that must be finite with 24 / 24 / 48
              / 48 K2 / K3a launches; host ms a step and peak memory.
  18. pretrain - OSCAR+ pretraining at VinVL-base width with a vocab of
              30522 (a generated vocab.txt): (a) aladin_torch.cli.pretrain,
              f32 with the kernel knobs off as aladin_tpu's CLI runs, bs 32 x
              (35 text + 50 regions), 20 iterations over a synthetic corpus
              of 128 images, warmup 4, checkpoints at 10 and 20: finite
              losses, the logged lr on WarmupLinearSchedule, both checkpoints
              loading back with no missing or unexpected key, host and card
              ms a step, peak memory; (b) from the trained state at dropout 0,
              one bf16 step with fused_attention and fused_layernorm against
              one without: loss and grad_norm within KNOB_LOSS_RTOL /
              KNOB_GNORM_RTOL, every gradient within KNOB_GNORM_RTOL (relative
              L2), every parameter within what one AdamW step allows; then a
              step at dropout 0.1 with exactly 12 / 12 / 24 / 24 K2 / K3a
              launches; host and card ms a step of both.
  19. classify - aladin_torch.cli.classify --task vqa and --task nlvr at
              VinVL-base width over make_synthetic_task_data (2054-d
              regions, 128 examples a split), bs 32 x (128 text + 50
              regions), f32 (plain attention: S 178 is past K2's regime),
              one epoch, --do_test: finite losses, a validation score in
              [0, 1], one prediction a test example; host and card ms a
              step (nlvr: 2 x 32 streams), peak memory.
  20. caption - image captioning at VinVL-base width and the COCO
              geometry (40 caption slots + 30 OD labels + 50 regions, L
              120): (a) aladin_torch.cli.captioning, f32 with the knobs off
              as aladin_tpu's CLI, over a synthetic corpus of 8 images, 4
              steps of 32, once a decoding mode: greedy with one SCST
              epoch, beam 5, --kv_cache and --use_cbs (every CBS caption
              holds a detected class word): finite losses and metrics, host
              and card ms a step, peak memory; (b) one bf16 step at dropout
              0 with K2 (2-D block masks, bias_q == S) and K3a against one
              without (train_fused's tolerances), and exactly 12 / 12 / 24
              / 24 K2 / K3a launches a step at dropout 0.1; (c) a captioner
              trained here on one fixed caption until its decisions are far
              apart (the smallest top-1 margin is printed) decodes 16
              images in f32 by full recompute and with the KV cache, greedy
              and beam 5: equal tokens, summed log-probs within
              DECODE_F32_RTOL, host and card ms a batch and a step of
              greedy in both modes; (d) the
              same in bf16, full-recompute greedy with fused_attention
              against without: equal tokens, log-probs within
              DECODE_BF16_ATOL, exactly 12 x 39 K2 forwards a batch.
  21. retrieval_oscar - aladin_torch.cli.retrieval_oscar at VinVL-base
              width over 32 synthetic images: one epoch of pair steps at 16
              anchors (32 rows x (70 text + 50 regions)), then the cross
              evaluation of 32 images x 160 captions (5120 pairs): finite
              losses, R@K, ms a step, pairs/s with the host tensorize and
              card seconds apart; one bf16 pair step with K2 + K3a against
              one without, and 12 / 12 / 24 / 24 launches a step.

Since the tensor-parallel slice, three more phases, run last (the serving
corpus is kept for them):

  parity    - aladin_torch.cli.parity, at VinVL-base
              width over the serving corpus (5k keys: 1000 images; 1k keys:
              500) from a released-format .pth.tar of main's random
              weights, not strict: every report section, K1 launched, the
              5k rows and scores equal to main's bf16 cli/test run bit for
              bit, the 1k rows equal to cli/test --eval_img_keys_file
              test_img_keys_1k.tsv (or off only by near-ties), encode,
              scoring and latency seconds.
  data_smoke - aladin_torch.cli.data_smoke over the serving corpus's train
              split: samples/s of the native and the Python reader at 1
              and 4 loader threads.
  tensor_parallel - K2 on one tp rank's heads (H 6 of
              12, head_offset 6) against its plain version and bit for bit
              against heads 6-11 of an H 12 launch, and its times at H 6
              and H 3 beside the bound and SDPA's; then two processes on
              the card, the ranks of a dp=1,tp=2 gloo group, each running
              the flagship B 128 bf16 step with K2 and K3a on its heads:
              against the one-process step at dropout 0 and at dropout 0.1
              (train_fused's knob tolerances on the loss, grad_norm and
              the gathered gradients, overall and leaf by leaf, every
              parameter within one Adam step), 24 / 24 / 48 / 48 launches
              a rank a step, ms a step, the gathered weights' f32 forward
              in a tp = 1 model (TP_FORWARD_ATOL), and the row-parallel
              partial product (bf16 operands, f32 result) on the tensor
              cores against the f32 product of the upcast operands.

Since the Kimi-Linear configuration, one more phase after those:

  kda       - K5 and K6 (csrc/kda_kernel.cu) at the condense cell's shapes:
              the 64 documents of h100_bench's condense_doc64 traffic packed
              end to end (258,984 tokens, 32 heads of 128, raw inputs in
              bf16). K5 against its plain version on two documents (output
              within KDA_O_RTOL, final states within KDA_PLAIN_S_RTOL) and,
              on the full batch, the longest document and three others
              against reference/kimi_linear.py::kda_chunked (KDA_O_RTOL,
              KDA_CHUNKED_S_RTOL), every document's tails equal to its last
              3 raw rows; K6 at batch 64 from those states, three steps
              against its plain version (KDA_O_RTOL, KDA_STEP_S_RTOL; tails
              equal). Card ms of both (CUDA events) beside
              h100_bench/lib/kda_bounds.py's bounds and the plain versions'
              ms; then the main path: greedy_decode_cached on Kimi-Linear
              cut to layers K K K M at the published widths (64 of 256
              experts), whose second batch must launch K5 once a KDA layer
              and replay K6 once a KDA layer and step, by the launch
              counters and by name in a device trace.

Then the total seconds, the kernels line ({"kernels": [...]}; K2 and K3a
also with their launches in one remat step, one pretraining step, one
caption step and one pair step, K2's forward in one caption decode batch,
K2's times at the captioning step's and the decoder's shapes, and K2 on
one tp rank's heads; K5 and K6 from the kda phase),
the card's name and power limit
as nvidia-smi prints them, and last {"ok": true, "device": {...}}. Any failed
phase raises, so the script exits nonzero without that last line. It also
refuses to run without a CUDA device or outside the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RECIPE = "alad-alignment-and-matching-distill.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12,  # dense tensor-core peaks
                  "f32": 67e12}  # f32 outside the tensor cores
# bf16: kernel and plain version multiply the same bf16-rounded operands
# exactly in f32 and differ only in the order of the f32 sums over D=768 and
# over the words (~1e-6 on scores of O(10)); 1e-3 leaves that room and still
# catches a wrong row, word or mask. int8: both sum the same integers
# exactly, so only the f32 descale may round.
BF16_ATOL = 1e-3
INT8_RTOL = 1e-5
# K2 and K3a outputs are bf16: kernel and plain version compute the same f32
# values with sums in another order (~1e-6 relative), then round once to
# bf16, which can move an element by one bf16 unit in the last place; one
# such unit at the largest output's magnitude is max|want| * 2^-7.
BF16_ULP = 2.0 ** -7
# f32 results of a reduction in another order (LayerNorm statistics, the
# dgamma / dbeta column sums over ~10^4 rows): relative to the largest.
F32_SUM_RTOL = 1e-4
# K4 and K4-dynx against their plain versions with f32 output: the int32
# sums are exact and the epilogue is the same f32 arithmetic, so without an
# activation they should agree exactly (1e-6 of the largest leaves room for
# a rounding); with one, erff / tanhf against torch's may differ by ulps.
K4_F32_RTOL = 1e-6
K4_F32_ACT_RTOL = 1e-5
# K3b's q against its plain version: the statistics are summed in another
# order, so a y on a .5 boundary of its scale may round the other way.
K3B_Q_EQUAL_SHARE = 0.999
# K5 / K6 against their plain versions and the chunked reference: o is
# bf16 on the card, so a value may round one bf16 unit apart (2^-8 of it)
# where the f32 values differ in their last bits; 2^-7 of the norm leaves
# room. The states are f32 on both sides: summed in another order (and the
# exponentials approximated) they drift ~1e-6 a token over a document
# against the plain version's token loop, and further against the chunked
# reference's other grouping at 16 k tokens; one step stays near one ulp.
KDA_O_RTOL = 2.0 ** -7
KDA_PLAIN_S_RTOL = 1e-4
KDA_CHUNKED_S_RTOL = 1e-3
KDA_STEP_S_RTOL = 1e-5
# alignment scores of the int8 encoder against the bf16 encoder's (the bound
# tests/test_quant.py puts on the encoder output cosine)
INT8_ENCODER_CORR = 0.99
# knobs on vs off, one train step at dropout 0: the fused path keeps the
# residual stream in bf16 (the kernel's y has x's dtype, as in aladin_tpu)
# where autocast's LayerNorm returns f32, so 24 LayerNorms differ by bf16
# roundings; the loss must agree to 1% and grad_norm to 5%.
KNOB_LOSS_RTOL = 1e-2
KNOB_GNORM_RTOL = 5e-2
# the reference ALADIN's GPU alignment head (bench.py)
REFERENCE_M_PAIRS_PER_S = 51.02
SYNTH_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "of", "the", "dog",
                "cat", "car", "tree", "person", "boat", "bird", "house", "number"]
               + [str(i) for i in range(10)])


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Milliseconds of card time per call of ``fn``: CUDA events around
    ``reps`` back-to-back calls that the host queues while a spin kernel
    holds the card, so the card runs them without waiting for the host.
    Unlike ``cuda_ms`` this leaves out the host's launch cost, which
    dominates short kernels. The spin lasts twice the time the host took to
    queue the calls; if the card still catches up with the host, the spin
    doubles and the measurement repeats."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * (time.perf_counter() - t0)
    for _ in range(4):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * 2e9))  # cycles: at most 2 GHz, so at least spin_s
        start.record()
        for _ in range(reps):
            fn()
        caught_up = start.query()  # the spin ended before the last call was queued
        stop.record()
        torch.cuda.synchronize()
        if not caught_up:
            return start.elapsed_time(stop) / reps
        spin_s *= 2
    raise RuntimeError("the card kept catching up with the host; no device time measured")


def corpus(gen, n_im, n_cap, s_im, s_s, d=768):
    """Random token sets with lengths uniform as in the benchmark
    (regions 5..S_im, words 4..S_s)."""
    import torch

    dev = gen.device
    return (torch.randn(n_im, s_im, d, generator=gen, device=dev),
            torch.randn(n_cap, s_s, d, generator=gen, device=dev),
            torch.randint(5, s_im + 1, (n_im,), generator=gen, device=dev),
            torch.randint(4, s_s + 1, (n_cap,), generator=gen, device=dev))


def mrsw_bound(args, dtype):
    """Least time for the kernel's work on these inputs: operand bytes read
    once plus the f32 output written once over HBM bandwidth, or the
    operations this data needs (valid regions x valid words x D x 2) over
    the tensor-core peak, whichever is larger: (ms, "bytes" | "operations")."""
    im, cap, il, sl = args
    d = im.shape[2]
    elem = 1 if dtype == "int8" else 2
    n_bytes = (im.shape[0] * (im.shape[1] - 1) + cap.shape[0] * (cap.shape[1] - 3)) * d * elem
    n_bytes += im.shape[0] * cap.shape[0] * 4
    ops = 2.0 * d * float((il - 1).sum()) * float((sl - 3).sum())
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops else "operations")


def launched_bound_ms(im_p, plan, dtype) -> float:
    """Operations the kernel multiplies (its operand layout: regions
    rounded up to 8, images to groups of 8, D to 128 bytes; the plan's
    tiles of 256 word columns) over the tensor-core peak, in ms."""
    from aladin_torch.ops.kernels import alignment_kernel as ak

    a, _ = ak._kernel_operands(im_p, im_p[0, :1])
    cols = len(plan.tiles) * plan.cols
    return 1e3 * 2.0 * a.shape[0] * cols * a.shape[1] / PEAK_OPS_PER_S[dtype]


def phase_env() -> str:
    import torch

    smi = nvidia_smi_line()
    try:
        import yaml  # noqa: F401
        has_yaml = True
    except ImportError:
        has_yaml = False
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "yaml": has_yaml})
    return smi


def phase_build() -> None:
    from aladin_torch.ops.kernels import build

    out = build.build_all(force=True)
    emit({"phase": "build", "sources": list(build.SOURCES), "seconds": out["seconds"]})


def phase_k1() -> dict:
    import torch

    from aladin_torch.eval.retrieval import score_by_caption_bucket
    from aladin_torch.ops.kernels import alignment_kernel as ak

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8}
    checks = []

    def compare(tag, got, want, name):
        err = (got - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        ok = err <= BF16_ATOL if name == "bf16" else rel <= INT8_RTOL
        finite = bool(torch.isfinite(got).all())
        checks.append({"case": tag, "dtype": name, "max_abs_err": err, "max_rel_err": rel,
                       "ok": ok and finite})
        if not (ok and finite):
            raise AssertionError(f"K1 disagrees with its plain version: {checks[-1]}")
        return err

    # a 1000 x 5000 comparison shape and the main path's (buffers of 51 slots;
    # the synthetic captions fall in one 16-slot bucket)
    shapes = {"1000x5000 S34/50": (1000, 5000, 34, 50), "main path 1000x5000 S51/16":
              (1000, 5000, 51, 16)}
    max_err = {"bf16": 0.0, "int8": 0.0}
    for tag, shape in shapes.items():
        args = corpus(gen, *shape)
        for name, dt in dtypes.items():
            got = ak.mrsw_scores(*args, compute_dtype=dt)
            want = ak.mrsw_scores_plain(*args, compute_dtype=dt)
            max_err[name] = max(max_err[name], compare(tag, got, want, name))
            got = ak.mrsw_scores_bucketed(*args, compute_dtype=dt)
            plain = lambda *a, dt=dt: ak.mrsw_scores_plain(*a, compute_dtype=dt)  # noqa: E731
            want = score_by_caption_bucket(plain, *args)
            max_err[name] = max(max_err[name], compare(tag + " bucketed", got, want, name))

    # zero floor: word 0 of caption 0 points against every region of images
    # 0 (full buffer: no floor, negative max) and 1 (short: floored at 0)
    im, cap, il, sl = corpus(gen, 4, 3, 34, 50)
    il[0], il[1] = 34, 10
    cap[0, 1] = -(im[0, 1:].sum(0) + im[1, 1:10].sum(0))
    for name, dt in dtypes.items():
        compare("zero floor", ak.mrsw_scores(im, cap, il, sl, compute_dtype=dt),
                ak.mrsw_scores_plain(im, cap, il, sl, compute_dtype=dt), name)

    # a score does not depend on the corpus shape (bf16: no per-call scales),
    # though the slice's captions pack into other tiles at other columns
    args = corpus(gen, *shapes["1000x5000 S34/50"])
    full = ak.mrsw_scores(*args)
    part = ak.mrsw_scores(args[0][100:300], args[1][1000:2500], args[2][100:300],
                          args[3][1000:2500])
    if not torch.equal(part, full[100:300, 1000:2500]):
        raise AssertionError("K1 scores changed with the corpus shape")
    # bucketing drops only zero words, which K1 sums after the real ones:
    # bf16 bucketed scores equal unbucketed ones bit for bit
    if not torch.equal(ak.mrsw_scores_bucketed(*args), full):
        raise AssertionError("K1 bucketed bf16 scores differ from unbucketed ones")

    # kernel and plain time on the prepared operands of the comparison shape
    timings = {}
    for name, dt in dtypes.items():
        im_p, words, _, plan, table = ak._packed(*args, dt)
        im_r, cap_r, _ = ak._prepare(*args, dt)
        bound_ms, bound_by = mrsw_bound(args, name)
        timings[name] = {
            "ms": cuda_ms(lambda: ak._launch(im_p, words, plan, table), 5),
            "plain_ms": cuda_ms(lambda: ak._plain_core(im_r, cap_r), 2),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        del im_r, cap_r
    emit({"phase": "k1", "checks": checks, "shape_independent": True,
          "bf16_atol": BF16_ATOL, "int8_rtol": INT8_RTOL, "timings_1000x5000": timings})

    # the benchmark shape: 5k x 25k, S_im 34, S_s 50, D 768, uniform lengths
    n_im, n_cap = 5000, 25000
    pairs = n_im * n_cap
    bench = corpus(gen, n_im, n_cap, 34, 50)
    bench_out = {}
    for name, dt in dtypes.items():
        im_p, words, _, plan, table = ak._packed(*bench, dt)
        ms = cuda_ms(lambda: ak._launch(im_p, words, plan, table), 2)
        bound_ms = mrsw_bound(bench, name)[0]
        launched_ms = launched_bound_ms(im_p, plan, name)
        bench_out[name] = {"ms": ms, "m_pairs_per_s": pairs / ms / 1e3,
                           "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                           "launched_bound_ms": launched_ms, "launched_bound_share": launched_ms / ms,
                           "wrapper_ms": cuda_ms(lambda: ak.mrsw_scores(*bench, compute_dtype=dt),
                                                 1)}
        if name == "bf16":
            # cuBLAS over a 1000 x 1000 slice of the same operands, per pair:
            # a yardstick for the kernel's mainloop (no max, no sum)
            _, cap_p, _ = ak._prepare(*bench, dt)
            a = im_p[:1000].reshape(-1, im_p.shape[2])
            b = cap_p[:1000].reshape(-1, cap_p.shape[2])
            gemm_ms = cuda_ms(lambda: torch.matmul(a, b.T), 3)
            bench_out[name]["gemm_only_ms"] = gemm_ms * pairs / 1e6
            del a, b, cap_p
        del im_p, words, table
    bucketed_ms = cuda_ms(lambda: ak.mrsw_scores_bucketed(*bench, compute_dtype=torch.int8), 1)
    bench_out["int8_bucketed"] = {"ms": bucketed_ms, "m_pairs_per_s": pairs / bucketed_ms / 1e3,
                                  "reference_m_pairs_per_s": REFERENCE_M_PAIRS_PER_S}
    del bench
    emit({"phase": "k1_bench", "shape": "5000x25000 S34/50 D768", "kernel": bench_out,
          "library_ms": None,
          "library_note": "no single PyTorch call computes MrSw (max over regions, sum over words); "
                          "gemm_only_ms is cuBLAS's product of the same bf16 operands alone"})
    return {"max_err": max_err, "timings": timings}


def write_oscar_dir(path: str, vocab, **knobs) -> None:
    """A VinVL-base-shaped OSCAR directory with random weights from a seed;
    ``knobs``: BertImgConfig fields its config.json sets (the kernels)."""
    import torch

    from aladin_torch.models.bert_img import BertImgConfig, BertImgModel

    # 12 layers, hidden 768, 12 heads, FFN 3072, vocab 30522, 2054-d
    cfg = BertImgConfig(**knobs)
    gen = torch.Generator().manual_seed(1234)
    model = BertImgModel(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * cfg.initializer_range)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg.to_json_dict(), f)
    torch.save({"bert." + k: v for k, v in model.state_dict().items()},
               os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")


def time_loader(oscar_dir: str, data: str, use_native_io: bool = True, keep: int = 8):
    """(seconds, the first ``keep`` batches): the time to read, tensorize and
    copy the encode batches to the card without running the model (the host
    data path's share of encode), through the native reader and tokenizer
    or, with ``use_native_io=False``, the pure-Python ones. Raises when the
    native path was asked for and not taken."""
    import torch

    from aladin_torch.cli.common import build_tokenizer
    from aladin_torch.config import DataArgs
    from aladin_torch.data.dataset import RetrievalDataset
    from aladin_torch.data.pipeline import BatchLoader
    from aladin_torch.data.tokenizer import BertWordPieceTokenizer

    args = DataArgs(data_dir=data, img_feat_file=os.path.join(data, "features.tsv"),
                    eval_model_dir=oscar_dir, max_seq_length=50, max_img_seq_length=34,
                    add_od_labels=True, eval_img_keys_file="test_img_keys.tsv")
    tok = build_tokenizer(args)
    if not use_native_io:
        tok = BertWordPieceTokenizer(tok.vocab)
    ds = RetrievalDataset(tok, args, "test", is_train=False, use_native_io=use_native_io)
    if (ds.native_enabled, tok.native_enabled) != (use_native_io, use_native_io):
        raise AssertionError(f"asked for native IO {use_native_io}, got reader "
                             f"{ds.native_enabled} and tokenizer {tok.native_enabled}")
    loader = BatchLoader(ds, 32, shuffle=False, drop_last=False, device="cuda")
    kept = []
    t0 = time.perf_counter()
    for i, batch in enumerate(loader.epoch(0)):
        if i < keep:
            kept.append(batch)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, kept


def serving_corpus(tmp: str):
    """(oscar dir, data dir, setup seconds): the VinVL-base-shaped backbone
    and a synthetic corpus of 1000 images / 5000 captions under ``tmp``."""
    from aladin_torch.data.dataset import make_synthetic_dataset

    t0 = time.perf_counter()
    oscar, data = os.path.join(tmp, "oscar"), os.path.join(tmp, "coco_ir")
    write_oscar_dir(oscar, SYNTH_VOCAB)
    make_synthetic_dataset(data, n_images=1000, feat_dim=2054)
    return oscar, data, time.perf_counter() - t0


# the port's NDCG against the numpy one below: the same gains, the port's in
# f32 (2 ** a float32 relevance), these in f64
NDCG_ATOL = 1e-6
NDCG_RANK = 25


def write_relevances(rel_dir: str, split: str, n_captions: int, n_images: int) -> dict:
    """Synthetic rougeL and spice relevance matrices from a seed, raw float32
    (n_captions, n_images) files as the offline builder writes them;
    returns {method: the matrix}."""
    import numpy as np

    os.makedirs(rel_dir, exist_ok=True)
    rng = np.random.RandomState(77)
    out = {}
    for method in ("rougeL", "spice"):
        out[method] = rng.rand(n_captions, n_images).astype(np.float32)
        out[method].tofile(os.path.join(rel_dir, f"coco-{split}-{method}.npy"))
    return out


def numpy_ndcg(scores, relevances: dict, data: str, n_sampled: int = 50):
    """({"i2t" | "t2i": {"rougel", "spice": mean NDCG@25}}, sampled): an
    NDCG written here from the definition, over every query of the
    (images, captions) score matrix: each query's candidates by score,
    descending (numpy's argsort reversed, the order ties take in the port
    and aladin_tpu), gains 2^rel - 1 over log2(rank + 2), over the ideal
    ranking's. i2t's queries are images over the captions' relevance
    column; t2i's captions over their row. Then, for 50 seeded queries each
    way, the per-query values against the port's DCG scorer on the files
    under ``data``; ``sampled`` counts them."""
    import numpy as np

    from aladin_torch.eval.dcg import DCG

    disc = 1.0 / np.log2(np.arange(NDCG_RANK) + 2.0)

    def per_query(s, r):
        top = np.argsort(s, axis=1)[:, ::-1][:, :NDCG_RANK]
        dcg = ((2.0 ** np.take_along_axis(r, top, 1).astype(np.float64) - 1.0) * disc).sum(1)
        best = -np.sort(-r.astype(np.float64), axis=1)[:, :NDCG_RANK]
        ideal = ((2.0 ** best - 1.0) * disc).sum(1)
        return np.where(ideal > 0, dcg / np.where(ideal > 0, ideal, 1.0), 0.0)

    names = {"rougeL": "rougel", "spice": "spice"}
    directions = {"i2t": (scores, "sentence", lambda r: r.T),
                  "t2i": (scores.T, "image", lambda r: r)}
    scorer = DCG({"dataset": {"name": "coco"}}, scores.shape[1], "test",
                 relevance_methods=list(relevances), rel_dir=os.path.join(data, "relevances"))
    rng = np.random.RandomState(5)
    out, sampled = {}, 0
    for d, (s, retrieval, view) in directions.items():
        vals = {m: per_query(s, view(r)) for m, r in relevances.items()}
        out[d] = {names[m]: float(v.mean()) for m, v in vals.items()}
        for q in rng.choice(s.shape[0], n_sampled, replace=False):
            port = scorer.compute_ndcg(scores.shape[0], int(q), np.argsort(s[q])[::-1], 0,
                                       retrieval)
            for m, v in vals.items():
                if abs(port[m] - v[q]) > NDCG_ATOL:
                    raise AssertionError(f"{d} query {q} {m}: the port's NDCG {port[m]} "
                                         f"against {v[q]}")
            sampled += 1
    return out, sampled


def recipe_bs() -> int:
    with open(os.path.join(ROOT, "aladin_torch", "configs", RECIPE)) as f:
        return json.load(f)["training"]["bs"]


def phase_main(tmp: str, oscar: str, data: str, setup_s: float):
    """cli/test at full width: bf16 scoring, int8 scoring, and the int8
    encoder (--int8_encoder) with bf16 scoring. Returns (each run's kernel
    launches, the bf16 run's results)."""
    import torch

    from aladin_torch.cli import test as cli_test

    counters = {"k1": "k1.launches", "k4_dynx": "k4_dynx.launches", "k4": "k4.launches",
                "k3b": "k3b.launches", "k3a": "k3a.fwd_launches"}
    launches, results = {}, {}
    common = [
        "--config", os.path.join(ROOT, "aladin_torch", "configs", RECIPE),
        "--eval_model_dir", oscar, "--data_dir", data,
        "--img_feat_file", os.path.join(data, "features.tsv"),
        "--eval_img_keys_file", "test_img_keys.tsv", "--max_seq_length", "50",
        "--max_img_seq_length", "34", "--add_od_labels", "--output_dir", tmp,
        "--logger_name", tmp, "--device", "cuda",
    ]
    batches = math.ceil(5000 / recipe_bs())
    relevances = write_relevances(os.path.join(data, "relevances"), "test", 5000, 1000)
    runs = (("bf16", []), ("int8", ["--compute_dtype", "int8"]),
            ("int8_encoder", ["--int8_encoder"]), ("ndcg", ["--ndcg"]))
    for name, extra in runs:
        before = launch_counts(counters)
        res = cli_test.run(common + extra)
        launches[name] = launches_since(before, counters)
        results[name] = res
        if launches[name]["k1"] == 0:
            raise AssertionError(f"{name} run never launched the MrSw kernel")
        want_dynx = 48 * batches if name == "int8_encoder" else 0  # 12 layers x 2 GEMMs x 2 passes
        if (launches[name]["k4_dynx"] != want_dynx or launches[name]["k4"]
                or launches[name]["k3b"] or launches[name]["k3a"]):
            raise AssertionError(f"{name} run launched {launches[name]}; expected "
                                 f"{want_dynx} K4-dynx ({batches} encode batches) and no K4/K3")
    for name, res in results.items():
        if res["native_io"] != {"reader": True, "tokenizer": True}:
            raise AssertionError(f"{name} run did not read through the native IO path: "
                                 f"{res['native_io']}")
    loader_s, native_batches = time_loader(oscar, data)
    python_loader_s, python_batches = time_loader(oscar, data, use_native_io=False)
    for a, b in zip(native_batches, python_batches, strict=True):
        for f in a.__dataclass_fields__:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"native and Python loaders disagree on {f}")
    for name, res in results.items():
        metrics = {**{f"matching_{k}": v for k, v in res["matching"].items()},
                   **{f"alignment_i2t_{k}": v for k, v in res["alignment_i2t"].items()},
                   **{f"alignment_t2i_{k}": v for k, v in res["alignment_t2i"].items()}}
        scores = res["scores"]
        if scores.shape != (1000, 5000) or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{name} run: bad scores {scores.shape} or metrics {metrics}")
        emit({"phase": "main", "run": name, "images": 1000, "captions": 5000,
              "encode_batches": batches, "setup_seconds": setup_s,
              "encode_seconds": res["encode_seconds"], "loader_only_seconds": loader_s,
              "loader_only_seconds_python_io": python_loader_s, "native_io": res["native_io"],
              "score_seconds": res["score_seconds"], "ndcg_seconds": res["ndcg_seconds"],
              "kernel_launches": launches[name], "metrics": metrics})

    def corr(a, b):
        a = torch.from_numpy(results[a]["scores"]).double().flatten()
        b = torch.from_numpy(results[b]["scores"]).double().flatten()
        return float(torch.corrcoef(torch.stack([a, b]))[0, 1])

    check = {"bf16_int8_score_corr": corr("bf16", "int8"),
             "bf16_int8_encoder_score_corr": corr("bf16", "int8_encoder")}
    if not check["bf16_int8_score_corr"] > 0.999:
        raise AssertionError(f"int8 and bf16 alignment scores disagree: {check}")
    if not check["bf16_int8_encoder_score_corr"] > INT8_ENCODER_CORR:
        raise AssertionError(f"the int8 encoder's alignment scores disagree with bf16's: {check}")
    res = results["ndcg"]
    got = {d: {m: res[f"alignment_{d}"][f"ndcg_{m}"] for m in ("rougel", "spice")}
           for d in ("i2t", "t2i")}
    want, sampled = numpy_ndcg(res["scores"], relevances, data)
    check["ndcg"] = {"run": got, "numpy": want, "atol": NDCG_ATOL, "sampled_queries": sampled,
                     "ndcg_seconds": res["ndcg_seconds"]}
    for d in got:
        for m in got[d]:
            if not (got[d][m] > 0 and abs(got[d][m] - want[d][m]) <= NDCG_ATOL):
                raise AssertionError(f"--ndcg {d} {m}: the run's {got[d][m]} against the numpy "
                                     f"NDCG@25 {want[d][m]}")
    emit({"phase": "main_check", **check, "int8_encoder_corr_limit": INT8_ENCODER_CORR,
          "loader_batches_equal_native_vs_python": len(native_batches)})
    return {name: launches[name] for name, _ in runs}, results["bf16"]


PARITY_SECTIONS = ("matching_5k", "alignment_5k", "matching_5fold", "alignment_5fold",
                   "matching_1k", "alignment_1k")


def _rows_equal(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in set(a) & set(b))


def near_tie_only(got, want, tol: float) -> bool:
    """Every alignment rank that differs between two (N_im, N_cap) score
    matrices sits on a near-tie: two of that query's scores within ``tol``."""
    import torch

    from aladin_torch.eval.recall import ranks_from_score_matrix

    g = [r.cpu() for r in ranks_from_score_matrix(torch.as_tensor(got))]
    w = [r.cpu() for r in ranks_from_score_matrix(torch.as_tensor(want))]
    for scores, gr, wr in ((want, g[0], w[0]), (want.T, g[1], w[1])):
        for q in torch.nonzero(gr != wr).flatten().tolist():
            row = torch.as_tensor(scores[q]).float()
            gaps = (row[:, None] - row[None, :]).abs()
            gaps.fill_diagonal_(float("inf"))
            if not gaps.min() < tol:
                return False
    return True


def phase_parity(tmp: str, oscar: str, data: str, main_bf16: dict) -> dict:
    """aladin_torch.cli.parity at VinVL-base width over the serving corpus
    (1000 images x 5000 captions; test_img_keys.tsv and the 500 images of
    test_img_keys_1k.tsv) from a released-format .pth.tar of the random
    weights (write_random_checkpoint: the weights main's cli/test runs
    evaluate), not strict: every report section present, K1 launched (the
    count read), the 5k rows equal to main's bf16 cli/test run's (the same
    encode batches: bit for bit), the 1k rows equal to cli/test
    --eval_img_keys_file test_img_keys_1k.tsv's (encoded in other batches:
    rows equal, or every differing rank a near-tie within BF16_ATOL); encode,
    scoring and latency seconds."""
    import numpy as np

    from aladin_torch.cli import parity
    from aladin_torch.cli import test as cli_test

    ckpt = os.path.join(tmp, "parity_ckpt.pth.tar")
    write_random_checkpoint(ckpt, oscar)
    common = ["--load_checkpoint", ckpt, "--eval_model_dir", oscar, "--data_dir", data,
              "--img_feat_file", os.path.join(data, "features.tsv"), "--max_seq_length", "50",
              "--max_img_seq_length", "34", "--add_od_labels", "--device", "cuda"]
    report_dir = os.path.join(tmp, "parity")
    before = launch_counts(K1_COUNTER)
    t0 = time.perf_counter()
    res = parity.run(common + ["--output_dir", report_dir, "--report_dir", report_dir])
    total_s = time.perf_counter() - t0
    k1_launches = launches_since(before, K1_COUNTER)["k1"]
    report = res["report"]
    if res["exit_code"] != 0 or k1_launches == 0:
        raise AssertionError(f"parity: exit {res['exit_code']}, {k1_launches} K1 launches")
    missing = [k for k in PARITY_SECTIONS if "rsum" not in report["results"].get(k, {})]
    if missing or not report["latency"] or len(report["checks"]) != 4 or not all(
            os.path.exists(os.path.join(report_dir, f"parity_report.{e}")) for e in ("json", "md")):
        raise AssertionError(f"parity report incomplete: missing {missing}, latency "
                             f"{report['latency']}, checks {report['checks']}")
    if (report["n_images_5k"], report["n_images_1k"]) != (1000, 500):
        raise AssertionError(f"parity protocols: {report['n_images_5k']} / {report['n_images_1k']}")
    rows = report["results"]

    def cli_rows(r):
        return ({k: v for k, v in r["matching"].items()},
                {**{f"i2t_{k}": v for k, v in r["alignment_i2t"].items()},
                 **{f"t2i_{k}": v for k, v in r["alignment_t2i"].items()}})

    m5, a5 = cli_rows(main_bf16)
    if not (_rows_equal(rows["matching_5k"], m5) and _rows_equal(rows["alignment_5k"], a5)
            and np.array_equal(res["scores_5k"], main_bf16["scores"])):
        raise AssertionError(f"parity 5k rows {rows['matching_5k']} {rows['alignment_5k']} != "
                             f"cli/test's {m5} {a5}")
    out_1k = os.path.join(tmp, "test_1k")
    one_k = cli_test.run(common + ["--eval_img_keys_file", "test_img_keys_1k.tsv",
                                   "--output_dir", out_1k, "--logger_name", out_1k])
    m1, a1 = cli_rows(one_k)
    scores_1k = res["scores_5k"][:500, :2500]
    equal_1k = _rows_equal(rows["matching_1k"], m1) and _rows_equal(rows["alignment_1k"], a1)
    if not equal_1k and not near_tie_only(one_k["scores"], scores_1k, BF16_ATOL):
        raise AssertionError(f"parity 1k rows {rows['matching_1k']} {rows['alignment_1k']} != "
                             f"cli/test's {m1} {a1}, and not by near-ties")
    emit({"phase": "parity", "card": nvidia_smi_line(), "images": 1000, "captions": 5000,
          "k1_launches": k1_launches, "sections": list(rows), "checks": report["checks"],
          "profile": report["profile"], "coverage": report["coverage"],
          "rows_5k_equal_cli_test": True, "rows_1k_equal_cli_test": equal_1k,
          "scores_1k_max_abs_diff_vs_cli_test": float(np.abs(one_k["scores"] - scores_1k).max()),
          "encode_seconds": res["encode_seconds"], "score_seconds": res["score_seconds"],
          "latency_seconds": res["latency_seconds"], "latency": report["latency"],
          "total_seconds": total_s, "rsum": {k: v["rsum"] for k, v in rows.items()}})
    return {"k1_launches": k1_launches}


def phase_data_smoke(oscar: str, data: str) -> dict:
    """aladin_torch.cli.data_smoke over the serving corpus's train split
    (1000 images x 5 captions, text 50, regions 34, bs 32): samples/s of the
    native and the pure-Python TSV reader at 1 and 4 loader threads, with
    the batches copied to the card."""
    from aladin_torch.cli import data_smoke

    rows = data_smoke.run(["--eval_model_dir", oscar, "--data_dir", data, "--img_feat_file",
                           os.path.join(data, "features.tsv"), "--max_seq_length", "50",
                           "--max_img_seq_length", "34", "--add_od_labels", "--num_workers",
                           "4", "--batch_size", "32", "--device", "cuda"])
    if [(r["mode"], r["threads"]) for r in rows] != [("native", 1), ("native", 4),
                                                      ("python", 1), ("python", 4)]:
        raise AssertionError(f"data_smoke rows: {rows}")
    if not all(r["samples"] == 4992 and r["samples_per_s"] > 0 for r in rows):
        raise AssertionError(f"data_smoke did not read every whole batch: {rows}")
    emit({"phase": "data_smoke", "card": nvidia_smi_line(), "rows": rows})
    return {"rows": rows}


def phase_encode_q8ln(oscar: str, data: str) -> dict:
    """eval.encode.encode_data at full width over 1000 rows of the serving
    corpus with quant_matmuls + fused_layernorm (K3b feeding K4), against
    the --int8_encoder model (K4-dynx) on the same rows."""
    import numpy as np
    import torch

    from aladin_torch.cli.common import build_model, build_tokenizer
    from aladin_torch.config import DataArgs, load_config
    from aladin_torch.data.dataset import RetrievalDataset
    from aladin_torch.data.pipeline import BatchLoader, batch_from_numpy
    from aladin_torch.eval.encode import encode_data

    keys = os.path.join(data, "test_img_keys_200.tsv")  # 200 images: 1000 caption rows
    with open(keys, "w") as f:
        f.write("\n".join(str(100 + i) for i in range(200)))
    args = DataArgs(data_dir=data, img_feat_file=os.path.join(data, "features.tsv"),
                    eval_model_dir=oscar, max_seq_length=50, max_img_seq_length=34,
                    add_od_labels=True, eval_img_keys_file=os.path.basename(keys),
                    int8_encoder=True)
    cfg = load_config(os.path.join(ROOT, "aladin_torch", "configs", RECIPE))
    ds = RetrievalDataset(build_tokenizer(args), args, "test", is_train=False)
    loader = BatchLoader(ds, cfg.training.bs, shuffle=False, drop_last=False, device="cuda")
    counters = {"k3b": "k3b.launches", "k4": "k4.launches", "k4_dynx": "k4_dynx.launches",
                "k3a": "k3a.fwd_launches"}
    batch = batch_from_numpy(ds.collate(np.arange(cfg.training.bs)), torch.device("cuda"))
    out, seconds, launches, profiles = {}, {}, {}, {}
    for name, knobs in (("int8_encoder", {}), ("q8ln", {"fused_layernorm": True}), ("bf16", {})):
        run_args = dataclasses.replace(args, int8_encoder=name != "bf16")
        model = build_model(cfg, run_args, torch.device("cuda"), **knobs)
        if name != "bf16":
            seconds[name] = []
            for _ in range(2):  # the first pass includes the kernels' first launches
                before = launch_counts(counters)
                t0 = time.perf_counter()
                out[name] = encode_data(model, loader, buffer_len=51)
                torch.cuda.synchronize()
                seconds[name].append(time.perf_counter() - t0)
            launches[name] = launches_since(before, counters)
        with torch.inference_mode():  # the card's time for one batch of the encode
            model(batch)
            profiles[name] = device_profile(lambda: model(batch), 3, top=6)
        del model
    want = 48 * len(loader)  # a batch: 12 layers x 2 (LNs or GEMMs) x 2 passes
    if launches["q8ln"] != {"k3b": want, "k4": want, "k4_dynx": 0, "k3a": 0}:
        raise AssertionError(f"q8ln encode launched {launches['q8ln']}, expected {want} "
                             f"K3b and K4 ({len(loader)} batches) and no K4-dynx or K3a")
    cos = {}
    for i, side in enumerate(("image", "caption")):
        a, b = out["int8_encoder"][i][:, 0], out["q8ln"][i][:, 0]  # the global embeddings
        if not (np.isfinite(b).all() and a.shape == b.shape == (len(ds), 768)):
            raise AssertionError(f"q8ln {side} globals: shape {b.shape} or not finite")
        c = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        cos[side] = {"median": float(np.median(c)), "min": float(c.min())}
        if not cos[side]["median"] > 0.99:
            raise AssertionError(f"q8ln and int8-encoder {side} globals disagree: {cos[side]}")
    emit({"phase": "encode_q8ln", "rows": len(ds), "batches": len(loader),
          "encode_seconds_first_second": seconds, "launches_second": launches,
          "global_cosine": cos,
          "card_ms_per_encode_batch": {k: p["device_ms"] for k, p in profiles.items()},
          "device_profile_one_batch": profiles})
    return launches["q8ln"]


def write_random_checkpoint(path: str, oscar: str) -> None:
    """A released-format .pth.tar of the flagship recipe on the VinVL-base
    backbone of ``oscar``, heads random from the recipe's seed: what
    ``cli/search build --load_checkpoint`` reads and its query encoder
    reloads."""
    import torch

    from aladin_torch.cli.common import _build_aladin
    from aladin_torch.config import DataArgs, ExperimentConfig

    with open(os.path.join(ROOT, "aladin_torch", "configs", RECIPE)) as f:
        recipe = json.load(f)
    args = DataArgs(eval_model_dir=oscar, max_seq_length=50, max_img_seq_length=34)
    model = _build_aladin(ExperimentConfig.from_dict(recipe), args)
    torch.save({"epoch": 0, "Eiters": 0, "config": recipe,
                "model": {"img_txt_enc." + k: v for k, v in model.state_dict().items()}}, path)


def ranked_recall(scores, direction: str, cpi: int, ks=(1, 5, 10)) -> dict:
    """cli/search's R@K of a dense (N_im, N_cap) score matrix, each query's
    candidates ranked by a stable descending sort (lax.top_k's order)."""
    import torch

    from aladin_torch.cli.search import _recall_at

    s = scores.T if direction == "t2i" else scores
    idx = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :max(ks)]
    return _recall_at(idx.cpu().numpy(), direction, cpi, list(ks))


def phase_search(tmp: str, oscar: str, data: str) -> dict:
    """cli/search at full width over the serving corpus: build, free-text
    and by-row queries, the recall curve against brute-force rankings,
    serial per-query latency in the three modes (queued, and served: each
    query's top index read back before the next), batched queries/s."""
    import numpy as np
    import torch

    from aladin_torch.cli import search as cli_search
    from aladin_torch.eval import latency
    from aladin_torch.eval.index import load_index
    from aladin_torch.eval.search import search
    from aladin_torch.ops.alignment import score_all_pairs
    from aladin_torch.ops.similarity import l2norm

    ckpt, idx_dir = os.path.join(tmp, "search_ckpt.pth.tar"), os.path.join(tmp, "index")
    write_random_checkpoint(ckpt, oscar)
    peaks = {}
    torch.cuda.reset_peak_memory_stats()
    built = cli_search.run([
        "build", "--index_dir", idx_dir, "--load_checkpoint", ckpt, "--eval_model_dir", oscar,
        "--data_dir", data, "--img_feat_file", os.path.join(data, "features.tsv"),
        "--eval_img_keys_file", "test_img_keys.tsv", "--max_seq_length", "50",
        "--max_img_seq_length", "34", "--add_od_labels", "--output_dir", tmp,
        "--logger_name", tmp, "--device", "cuda"])
    peaks["build"] = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    index = load_index(idx_dir)
    load_s = time.perf_counter() - t0
    if (index.n_images, index.n_captions) != (1000, 5000):
        raise AssertionError(f"index holds {index.n_images} x {index.n_captions}")
    cpi = index.captions_per_img

    # free text that repeats caption rows j gives the hits of --query_index j
    rows = [11, 2500, 4999]
    texts = [a for j in rows for a in ("--text", index.meta["captions"][j])]
    by_row = [a for j in rows for a in ("--query_index", str(j))]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cli_search.run(["query", "--index_dir", idx_dir, *texts, *by_row, "--device", "cuda"])
    query_s = time.perf_counter() - t0
    res_i2t = cli_search.run(["query", "--index_dir", idx_dir, "--direction", "i2t",
                              "--query_index", "0", "--query_index", "999", "--device", "cuda"])
    peaks["query"] = torch.cuda.max_memory_allocated()
    text_hits, row_hits = res[:len(rows)], res[len(rows):]
    for t, r in zip(text_hits, row_hits):
        if [h["image_key"] for h in t["hits"]] != [h["image_key"] for h in r["hits"]]:
            raise AssertionError(f"free text and its caption row disagree: {t} {r}")
    for r in res + res_i2t:
        if len(r["hits"]) != 10 or not all(math.isfinite(h["score"]) for h in r["hits"]):
            raise AssertionError(f"bad hits {r}")
    text_score_diff = max(abs(a["score"] - b["score"]) for t, r in zip(text_hits, row_hits)
                          for a, b in zip(t["hits"], r["hits"]))

    # the curve, each direction against brute-force rankings of the same tensors
    curves = {}
    for direction in ("t2i", "i2t"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        curves[direction] = cli_search.run([
            "curve", "--index_dir", idx_dir, "--direction", direction,
            "--shortlists", "10,25,50,100", "--device", "cuda"])
        peaks[f"curve_{direction}"] = torch.cuda.max_memory_allocated()
        curves[f"{direction}_seconds"] = time.perf_counter() - t0
    with torch.inference_mode():
        brute = {}
        for direction in ("t2i", "i2t"):
            corpus = index.corpus("image" if direction == "t2i" else "caption", "cuda")
            q_sets, q_lens = index.query_buffers("caption" if direction == "t2i" else "image")
            q = torch.as_tensor(q_sets, device="cuda")
            ql = torch.as_tensor(q_lens, device="cuda")
            glob_q = q[:, 0] / torch.clamp(torch.linalg.norm(q[:, 0], dim=-1, keepdim=True),
                                           min=1e-12)
            match = glob_q @ corpus.globals.T  # stage 1's orientation: (queries, corpus)
            match = match.T if direction == "t2i" else match
            if direction == "t2i":  # (1000 images, 5000 captions) either way
                full = score_all_pairs(corpus.token_sets, l2norm(q, eps=1e-12), corpus.lengths,
                                       ql, "MrSw", 256, normalized=True)
            else:
                full = score_all_pairs(l2norm(q, eps=1e-12), corpus.token_sets, ql,
                                       corpus.lengths, "MrSw", 256, normalized=True)
            brute[direction] = {"matching-only": ranked_recall(match, direction, cpi),
                                "full-rerank": ranked_recall(full, direction, cpi)}
            del corpus, full
    for direction, want in brute.items():
        got = {r["stage"]: r["recall"] for r in curves[direction]["rows"]}
        for stage, w in want.items():
            if got[stage] != w:
                raise AssertionError(f"curve {direction} {stage}: {got[stage]} != brute {w}")

    # serial per-query latency and batched throughput, t2i over 1000 images
    img = index.corpus("image", "cuda")
    q_sets, q_lens = index.query_buffers("caption")
    serial = {}
    for mode in latency.MODES:
        sec, note = latency.serial_query_latency(img, q_sets, q_lens, mode=mode, shortlist=100,
                                                 n_serial=64)
        run = latency.make_serial_runner(mode, shortlist=100)
        qs = torch.as_tensor(q_sets[:64], device="cuda")
        ql = torch.as_tensor(q_lens[:64], device="cuda")
        prof = device_profile(lambda: run(qs, ql, img), 1, top=4)
        # the loop above queues query i + 1 while the card runs query i; a
        # served query waits for its top index on the host before the next
        served = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(64):
                run(qs[i:i + 1], ql[i:i + 1], img).item()
            served = min(served, (time.perf_counter() - t0) / 64)
        serial[mode] = {"s_per_query": sec, "note": note,
                        "served_s_per_query": served,
                        "card_s_per_query": prof["device_ms"] / 1e3 / 64,
                        "profiler_wall_s_per_query": prof["wall_ms"] / 1e3 / 64,
                        "top": prof["top"]}
    batched = {}
    q_all = torch.as_tensor(q_sets, device="cuda")  # a server's queries come from the card
    for name, rerank in (("matching", False), ("two_stage", True)):
        search(img, q_all[:64], q_lens[:64], direction="t2i", rerank=rerank)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        search(img, q_all, q_lens, direction="t2i", rerank=rerank, shortlist=100)
        torch.cuda.synchronize()
        batched[name] = {"queries": len(q_all), "queries_per_s":
                         len(q_all) / (time.perf_counter() - t0)}
    emit({"phase": "search", "card": nvidia_smi_line(), "images": index.n_images,
          "captions": index.n_captions,
          "build_seconds": built["seconds"], "build_encode_seconds": built["encode_seconds"],
          "index_load_seconds": load_s, "query_seconds": query_s,
          "free_text_equals_row": True, "free_text_max_score_diff": text_score_diff,
          "curves": curves, "brute_force": brute,
          "serial_latency_n64_shortlist100": serial,
          "reference_s_per_query": {"matching": latency.REF_MATCHING_S,
                                    "full_alignment": latency.REF_ALIGNMENT_S},
          "batched": batched, "peak_memory_bytes": peaks,
          "hits_example": {"t2i": res[0]["hits"][:3], "i2t": res_i2t[0]["hits"][:3]}})
    return {"peaks": peaks}


def phase_streaming() -> dict:
    """Streaming recall on the card: (a) the matching head at 5k x 25k, its
    ground truth against the tiles bit for bit; (b) the alignment head
    through K1 at the bench.py shape against K1's full matrix, and K1
    against its plain version on a sweep tile and a ground-truth block;
    (c) compute_recall at 100k x 500k, past the dense limit, its ground
    truth against the first 100000 x 32768 sweep tile bit for bit."""
    import torch
    import torch.nn.functional as F

    from aladin_torch.eval import streaming as st
    from aladin_torch.eval.recall import (STREAMING_SCORE_BYTES, compute_recall,
                                          ranks_from_score_matrix)
    from aladin_torch.ops.kernels.alignment_kernel import mrsw_scores, mrsw_scores_plain
    from aladin_torch.ops.similarity import l2norm

    gen = torch.Generator(device="cuda").manual_seed(11)
    cpi = 5

    def planted(n_im, d=768):
        """Unit captions; each image its first caption nudged by noise, so
        the ground truth mostly outranks the rest (streaming_recall_bench.py's
        corpus)."""
        caps = F.normalize(torch.randn(n_im * cpi, d, generator=gen, device="cuda"), dim=1)
        noise = F.normalize(torch.randn(n_im, d, generator=gen, device="cuda"), dim=1)
        return F.normalize(0.9 * caps[::cpi] + 0.45 * noise, dim=1), caps

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def ranks(scores):
        return [r.cpu().numpy() for r in ranks_from_score_matrix(scores, cpi)]

    out = {}
    # (a) matching, 5000 x 25000, cap_block 4096: 7 tiles
    ims, caps = planted(5000)
    block = 4096
    gt = st.matching_ground_truth(ims, caps, cpi, block)
    tiles = torch.cat([st._matching_tile(ims, F.pad(caps[lo:lo + block],
                                                    (0, 0, 0, block - caps[lo:lo + block].shape[0])))
                       for lo in range(0, caps.shape[0], block)], dim=1)[:, :caps.shape[0]]
    j = torch.arange(caps.shape[0], device="cuda")
    gt_equal = int((gt == tiles[j // cpi, j]).sum())
    if gt_equal != caps.shape[0]:
        raise AssertionError(f"matching ground truth equals {gt_equal} of {caps.shape[0]} "
                             "tile entries")
    streamed, sec = timed(lambda: st.streaming_matching_ranks(ims, caps, cpi, cap_block=block))
    for s, w in zip(streamed, ranks(tiles)):
        if not (s == w).all():
            raise AssertionError("streamed matching ranks differ from the tiles' matrix")
    dense_ranks = ranks(ims @ caps.T)
    diffs = [int((s != w).sum()) for s, w in zip(streamed, dense_ranks)]
    dense_m = compute_recall(ims.repeat_interleave(cpi, 0), caps, cpi, device="cuda")
    stream_m = st.streaming_matching_recall(ims, caps, cpi, cap_block=block)
    if dense_m != stream_m:
        raise AssertionError(f"streamed R@K {stream_m} != dense {dense_m}")
    out["matching_5k"] = {"cap_block": block, "tiles": -(-caps.shape[0] // block),
                          "gt_equals_tiles": gt_equal, "seconds": sec,
                          "rank_diffs_vs_dense_matmul_i2t_t2i": diffs, "recall": stream_m}
    del tiles, gt

    # (b) alignment through K1 at 5000 x 25000, R 34, W 50, bf16, cap_block 2048
    im, cap, il, cl = corpus(gen, 5000, 25000, 34, 50)
    im_rows, il_rows = im.repeat_interleave(cpi, 0), il.repeat_interleave(cpi, 0)
    before = launch_counts(K1_COUNTER)
    streamed, sec = timed(lambda: st.streaming_alignment_ranks(im_rows, cap, il_rows, cl, "MrSw",
                                                               cpi, cap_block=2048))
    launches = launches_since(before, K1_COUNTER)["k1"]
    want_launches = -(-25000 // 2048) + -(-25000 // 512)
    if launches != want_launches:
        raise AssertionError(f"streaming launched K1 {launches} times, expected {want_launches}")
    del im_rows, il_rows
    ims_n, caps_n = l2norm(im, eps=1e-12), l2norm(cap, eps=1e-12)
    dense = mrsw_scores(ims_n, caps_n, il, cl)
    for s, w in zip(streamed, ranks(dense)):
        if not (s == w).all():
            raise AssertionError("streamed alignment ranks differ from K1's full matrix")
    # K1 against its plain version on the inputs of the path's two shapes:
    # the first sweep tile and the first ground-truth block (captions 0..511
    # against their own images)
    pair = torch.arange(512, device="cuda") // cpi
    k1_err = {}
    for tag, args in (("sweep tile 5000x2048", (ims_n, caps_n[:2048], il, cl[:2048])),
                      ("ground-truth block 512x512",
                       (ims_n[pair], caps_n[:512], il[pair], cl[:512]))):
        got, want = mrsw_scores(*args), mrsw_scores_plain(*args)
        k1_err[tag] = (got - want).abs().max().item()
        if not (k1_err[tag] <= BF16_ATOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"K1 disagrees with its plain version on the {tag}: "
                                 f"{k1_err[tag]} > {BF16_ATOL}")
    out["alignment_5k"] = {"cap_block": 2048, "k1_launches": launches, "seconds": sec,
                           "pairs_per_s": 5000 * 25000 / sec, "ranks_equal_dense_k1": True,
                           "k1_vs_plain_max_abs_err": k1_err, "bf16_atol": BF16_ATOL}
    del im, cap, ims_n, caps_n, dense

    # (c) compute_recall at 100000 x 500000 (streams: the matrix would be 200 GB)
    ims, caps = planted(100_000)
    if not 4.0 * ims.shape[0] * caps.shape[0] > STREAMING_SCORE_BYTES:
        raise AssertionError("the 100k x 500k case would not stream")
    img_rows = ims.repeat_interleave(cpi, 0)
    torch.cuda.reset_peak_memory_stats()
    m, sec = timed(lambda: compute_recall(img_rows, caps, cpi, device="cuda"))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in m.values()) or not 0 <= m["t2i_r1"] <= 100:
        raise AssertionError(f"100k x 500k recall: {m}")
    # the ground truth against the first sweep tile at this size, bit for bit,
    # on the operands compute_recall passes (the strided unique-image rows;
    # the default cap_block 32768 and gt_block 4096)
    ims_c, first = st._dev(img_rows[::cpi], torch.device("cuda")), caps[:32768]
    gt = st.matching_ground_truth(ims_c, first, cpi, 4096)
    tile = st._matching_tile(ims_c, first)
    j = torch.arange(first.shape[0], device="cuda")
    gt_equal = int((gt == tile[j // cpi, j]).sum())
    del tile, gt
    if gt_equal != first.shape[0]:
        raise AssertionError(f"100k ground truth equals {gt_equal} of {first.shape[0]} entries "
                             "of the first sweep tile")
    out["matching_100k"] = {"seconds": sec, "pairs_per_s": 1e5 * 5e5 / sec, "recall": m,
                            "peak_memory_bytes": peak,
                            "gt_equals_first_tile": gt_equal}
    del ims, caps, img_rows, ims_c, first
    emit({"phase": "streaming", "card": nvidia_smi_line(), **out})
    return {"k1_launches": launches, "k1_max_err": max(k1_err.values())}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_parallel(tmp: str) -> dict:
    """Data parallelism on a one-rank NCCL group (one card): the sharded
    scorers, sharded_search, the mesh streaming sweeps, the data-parallel
    step and its CUDA graph, and cli/train under the group. K1's launches
    are counted on the sharded paths only (the comparisons run after the
    counts are read)."""
    from aladin_torch.parallel.distributed import initialize, shutdown
    from aladin_torch.parallel.mesh import create_mesh

    initialize(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0, device="cuda")
    try:
        return _parallel_checks(tmp, create_mesh("dp=1"))
    finally:
        shutdown()  # after the checks' CUDA graphs are gone with their frame


def _parallel_checks(tmp: str, mesh) -> dict:
    """The body of ``phase_parallel`` on the group's mesh."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from aladin_torch.cli import train as cli_train
    from aladin_torch.eval import streaming as st
    from aladin_torch.eval.index import load_index
    from aladin_torch.eval.search import search, sharded_search
    from aladin_torch.ops.kernels.alignment_kernel import mrsw_scores, mrsw_scores_plain
    from aladin_torch.parallel.distributed import get_world_size
    from aladin_torch.parallel.mesh import sharded_mrsw_scores
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_multi_train_step, make_train_step

    out = {"backend": dist.get_backend(), "world_size": get_world_size(), "card": nvidia_smi_line()}
    host_ms, launches = {}, {"bf16": 0, "int8": 0}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        host_ms[name] = 1e3 * (time.perf_counter() - t0)
        return res

    # (a) the corpus-sharded K1 at 1000 x 5000, VinVL-base widths
    gen = torch.Generator(device="cuda").manual_seed(21)
    args = corpus(gen, 1000, 5000, 34, 50)
    sharded, k1_err = {}, {}
    for name, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        before = launch_counts(K1_COUNTER)
        sharded[name] = timed(f"sharded_mrsw_{name}", lambda dt=dt: sharded_mrsw_scores(
            mesh, *args, compute_dtype=dt, small_corpus_fallback=False))
        k1 = launches_since(before, K1_COUNTER)["k1"]
        launches[name] += k1
        if k1 != 1:
            raise AssertionError(f"sharded {name} scoring launched K1 {k1} times")
        plain = mrsw_scores_plain(*args, compute_dtype=dt)
        k1_err[name] = (sharded[name] - plain).abs().max().item()
        unsharded = mrsw_scores(*args, compute_dtype=dt)
        if name == "bf16":
            ok = torch.equal(sharded[name], unsharded) and k1_err[name] <= BF16_ATOL
        else:
            scale = unsharded.abs().max().item()
            ok = ((sharded[name] - unsharded).abs().max().item() <= INT8_RTOL * scale
                  and k1_err[name] <= INT8_RTOL * plain.abs().max().item())
        if not ok:
            raise AssertionError(f"sharded {name} K1 scores disagree: {k1_err[name]} from plain")
    out["sharded_mrsw_1000x5000"] = {"bf16_equals_unsharded_bitwise": True,
                                     "max_abs_err_vs_plain": k1_err}
    del args, sharded

    # (b) sharded_search against search on the serving index, both ways
    index = load_index(os.path.join(tmp, "index"))
    agree = {}
    for direction in ("t2i", "i2t"):
        modality = "image" if direction == "t2i" else "caption"
        q_sets, q_lens = index.query_buffers("caption" if direction == "t2i" else "image")
        q_sets, q_lens = q_sets[:256], q_lens[:256]
        corp = index.corpus(modality, "cuda")
        want = search(corp, q_sets, q_lens, direction=direction)
        got = timed(f"sharded_search_{direction}", lambda: sharded_search(
            mesh, corp, q_sets, q_lens, direction=direction))
        if not ((got[1] == want[1]).all() and (got[0] == want[0]).all()):
            raise AssertionError(f"sharded_search {direction} differs from search")
        agree[direction] = {"queries": len(q_sets), "indices_equal": True, "scores_equal": True}
    out["sharded_search"] = agree

    # (c) the mesh streaming sweeps against the solo ones at 5000 x 25000
    cpi = 5
    ims = F.normalize(torch.randn(5000, 768, generator=gen, device="cuda"), dim=1)
    caps = F.normalize(torch.randn(25000, 768, generator=gen, device="cuda"), dim=1)
    solo = st.streaming_matching_ranks(ims, caps, cpi, cap_block=4096, topk=5)
    meshed = timed("mesh_matching_sweep", lambda: st.streaming_matching_ranks(
        ims, caps, cpi, cap_block=4096, topk=5, mesh=mesh))
    same = all((a == b).all() for a, b in zip(solo[:2], meshed[:2]))
    if not (same and all((a == b).all() for a, b in zip(solo[2], meshed[2]))):
        raise AssertionError("the mesh matching sweep differs from the solo sweep")
    im, cap, il, cl = corpus(gen, 5000, 25000, 34, 50)
    im_rows, il_rows = im.repeat_interleave(cpi, 0), il.repeat_interleave(cpi, 0)
    solo = st.streaming_alignment_ranks(im_rows, cap, il_rows, cl, "MrSw", cpi, cap_block=2048)
    before = launch_counts(K1_COUNTER)
    meshed = timed("mesh_alignment_sweep", lambda: st.streaming_alignment_ranks(
        im_rows, cap, il_rows, cl, "MrSw", cpi, cap_block=2048, mesh=mesh))
    sweep_launches = launches_since(before, K1_COUNTER)["k1"]
    launches["bf16"] += sweep_launches
    if sweep_launches != -(-25000 // 2048) + -(-25000 // 512):
        raise AssertionError(f"the mesh alignment sweep launched K1 {sweep_launches} times")
    if not all((a == b).all() for a, b in zip(solo, meshed)):
        raise AssertionError("the mesh alignment sweep differs from the solo sweep")
    out["mesh_streaming_5000x25000"] = {"matching_equals_solo": True,
                                        "alignment_equals_solo": True,
                                        "alignment_k1_launches": sweep_launches}
    del ims, caps, im, cap, il, cl, im_rows, il_rows

    # (d) the data-parallel step at B 128, knobs on, dropout 0: the plain step's bits
    def bitwise_states(a, b):
        return all(torch.equal(p, q) for p, q in zip(a.trainable, b.trainable)) and all(
            torch.equal(a.optimizer.state[p][k], v) for p, q in zip(a.trainable, b.trainable)
            for k, v in b.optimizer.state[q].items())

    cfg, model = flagship_train_model(True, 0.0)
    start = {n: v.detach().clone() for n, v in model.state_dict().items()}
    batches = [synth_train_batch(128, seed=30 + i) for i in range(GRAPH_K)]
    plain = TrainState(cfg, model, steps_per_epoch=100)
    plain_rows = [make_train_step(model, cfg, torch.bfloat16)(plain, x, 0) for x in batches[:2]]
    _, dp_model = flagship_train_model(True, 0.0, start)
    dp = TrainState(cfg, dp_model, steps_per_epoch=100)
    dp_step = make_train_step(dp_model, cfg, torch.bfloat16, mesh)
    dp_rows = timed("dp_step_x2", lambda: [dp_step(dp, x, 0) for x in batches[:2]])
    if not (all(torch.equal(a[n], b[n]) for a, b in zip(dp_rows, plain_rows) for n in a)
            and bitwise_states(dp, plain)):
        raise AssertionError("the data-parallel step differs from the plain step")
    del model, plain, dp_model, dp, plain_rows

    # (e) a CUDA graph of 8 data-parallel steps, the collectives captured
    _, eager_model = flagship_train_model(True, 0.0, start)
    eager = TrainState(cfg, eager_model, steps_per_epoch=100)
    eager_step = make_train_step(eager_model, cfg, torch.bfloat16, mesh)
    want = timed("dp_eager_x8", lambda: [eager_step(eager, x, 0) for x in batches])
    _, graph_model = flagship_train_model(True, 0.0, start)
    graphed = TrainState(cfg, graph_model, steps_per_epoch=100)
    multi = make_multi_train_step(graph_model, cfg, torch.bfloat16, k=GRAPH_K, mesh=mesh)
    got = timed("dp_graph_capture_and_replay", lambda: multi(graphed, batches, 0))
    if not (all(torch.equal(got[n], torch.stack([w[n] for w in want])) for n in got)
            and bitwise_states(graphed, eager)):
        raise AssertionError("the data-parallel CUDA graph differs from the eager steps")
    timed("dp_graph_replay_x8", lambda: multi(graphed, batches, 0))
    out["dp_step_b128"] = {"equals_plain_bitwise_steps": 2,
                           "graph_equals_eager_bitwise_steps": GRAPH_K,
                           "host_ms_per_step": {"eager": host_ms["dp_eager_x8"] / GRAPH_K,
                                                "graph": host_ms["dp_graph_replay_x8"] / GRAPH_K}}
    del eager_model, eager, graph_model, graphed, multi, batches, start

    # (f) cli/train for one epoch under the group (one rank: no mesh)
    run_dir = os.path.join(tmp, "dp_cli")
    res = timed("cli_train", lambda: cli_train.run([
        "--config", os.path.join(ROOT, "aladin_torch", "configs", RECIPE), "--synthetic",
        "--max_seq_length", "20", "--max_img_seq_length", "12", "--img_feature_dim", "32",
        "--num_epochs", "1", "--val_step", "0", "--output_dir", run_dir,
        "--logger_name", run_dir, "--mesh_shape", "dp=-1", "--device", "cuda"]))
    if res["trainer"].mesh is not None or not os.path.exists(res["checkpoint"]):
        raise AssertionError("cli/train under a one-rank group took a mesh or wrote no checkpoint")
    out["cli_train_under_group"] = {"steps": res["state"].step, "checkpoint_written": True}
    emit({"phase": "parallel", **out, "host_ms": host_ms, "k1_launches": launches})
    return {"k1_launches": launches, "k1_max_err": k1_err}


def bound(n_bytes: float, ops: float, peak: str):
    """(ms, "bytes" | "operations"): the larger of bytes over HBM bandwidth
    and operations over the ``peak`` rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[peak]
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops else "operations")


def attention_bound(b, s, h, d, q_dim, backward: bool):
    """K2's least time: 4 (forward) or 10 (backward) x B*H*S^2*d operations
    at the bf16 peak, against q, k, v (and g) read and ctx (dq, dk, dv)
    written once in bf16 plus the f32 bias read once."""
    ops = (10.0 if backward else 4.0) * b * h * s * s * d
    n_bytes = (7 if backward else 4) * b * s * h * d * 2 + b * q_dim * s * 4
    return bound(n_bytes, ops, "bf16")


def check_close(checks, what, tag, got, want, tol):
    """Append {case, max_abs_err, tol, ok} and raise unless got is finite and
    within ``tol`` of want everywhere; returns the error."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    checks.append({"case": tag, "max_abs_err": err, "tol": tol, "ok": err <= tol and finite})
    if not checks[-1]["ok"]:
        raise AssertionError(f"{what} disagrees with its plain version: {checks[-1]}")
    return err


def phase_k2() -> dict:
    """K2 forward and backward against the plain versions at B 128, S 50,
    84, 134 and 160, H 12, d 64, bf16; then their times at the path's
    shapes (S 50 and 84); then the 2-D path (``k2_block_masks``)."""
    import torch
    import torch.nn.functional as F

    from aladin_torch.ops.kernels import attention_kernel as ak

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, d = 128, 12, 64
    checks, max_err = [], {"fwd": 0.0, "bwd": 0.0}

    def inputs(s, q_dim):
        q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(4))
        if q_dim == 1:  # a key-padding mask, as the model passes it
            lens = torch.randint(4, s + 1, (b,), generator=gen, device="cuda")
            keep = (torch.arange(s, device="cuda")[None] < lens[:, None])[:, None, :]
        else:  # a 2-D mask
            keep = torch.rand(b, s, s, generator=gen, device="cuda") > 0.2
        keep[0] = False  # a fully padded row stays finite (-10000, not -inf)
        return q, k, v, g, (~keep).float() * -10000.0

    for s in (50, 84, 134, 160):
        for q_dim in (1, s):
            q, k, v, g, bias = inputs(s, q_dim)
            for rate in (0.0, 0.1):
                tag = f"S{s} Q{q_dim} rate{rate}"
                args = (q, k, v, bias)
                extra = (1000 + s, rate, True)
                want = ak.attention_forward_plain(*args, *extra)
                got = ak.attention_forward(*args, *extra)
                max_err["fwd"] = max(max_err["fwd"], check_close(
                    checks, "K2 forward", tag + " ctx", got, want,
                    BF16_ULP * want.float().abs().max().item()))
                wants = ak.attention_backward_plain(q, k, v, bias, g, *extra)
                gots = ak.attention_backward(q, k, v, bias, g, *extra)
                for name, gt, wt in zip(("dq", "dk", "dv"), gots, wants):
                    max_err["bwd"] = max(max_err["bwd"], check_close(
                        checks, "K2 backward", f"{tag} {name}", gt, wt,
                        BF16_ULP * wt.float().abs().max().item()))

    # times at the path's shapes: key-padding bias, dropout 0.1 with the
    # seed on the card, as the model passes it (an int seed adds a fill; the
    # library call at rate 0: its dropout draws its own mask)
    timings = {}
    for s in (50, 84):
        q, k, v, g, bias = inputs(s, 1)
        extra = (torch.full((), 7, dtype=torch.int64, device="cuda"), 0.1, True)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask = bias[:, None].to(torch.bfloat16)  # (B, 1, 1, S)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        gt = g.transpose(1, 2)
        fwd_bound, fwd_by = attention_bound(b, s, h, d, 1, False)
        bwd_bound, bwd_by = attention_bound(b, s, h, d, 1, True)
        rate0 = (7, 0.0, True)  # the library call's rate
        timings[s] = {
            "fwd": {"ms": device_ms(lambda: ak.attention_forward(q, k, v, bias, *extra), 20),
                    "ms_rate0": device_ms(lambda: ak.attention_forward(q, k, v, bias, *rate0), 20),
                    "event_ms": cuda_ms(lambda: ak.attention_forward(q, k, v, bias, *extra), 20),
                    "plain_ms": device_ms(
                        lambda: ak.attention_forward_plain(q, k, v, bias, *extra), 5),
                    "library_ms": device_ms(sdpa_fwd, 20),
                    "bound_ms": fwd_bound, "bound_by": fwd_by},
            "bwd": {"ms": device_ms(lambda: ak.attention_backward(q, k, v, bias, g, *extra), 20),
                    "ms_rate0": device_ms(
                        lambda: ak.attention_backward(q, k, v, bias, g, *rate0), 20),
                    "event_ms": cuda_ms(
                        lambda: ak.attention_backward(q, k, v, bias, g, *extra), 20),
                    "plain_ms": device_ms(
                        lambda: ak.attention_backward_plain(q, k, v, bias, g, *extra), 5),
                    "library_ms": device_ms(lambda: torch.autograd.grad(
                        out, (qt, kt, vt), gt, retain_graph=True), 20),
                    "bound_ms": bwd_bound, "bound_by": bwd_by},
        }
        for t in timings[s].values():
            t["bound_share"] = t["bound_ms"] / t["ms"]
        del out
    block_masks = k2_block_masks(gen, checks, max_err)
    emit({"phase": "k2", "checks": checks, "tolerance": "max|want| * 2^-7 (one bf16 ulp)",
          "timings": {f"B{b} S{s} H{h} d{d} bf16": t for s, t in timings.items()},
          "block_mask_timings": block_masks,
          "timing": "ms, plain_ms, library_ms: card time (device_ms); ms_rate0: the kernel's "
                    "card time at dropout 0, as the library call runs; event_ms: CUDA events "
                    "around back-to-back wrapper calls (host launch cost included); "
                    "bound_share: bound_ms / ms",
          "library": "F.scaled_dot_product_attention with the bias as a bf16 mask, rate 0; "
                     "backward: torch.autograd.grad through it"})
    return {"max_err": max_err, "timings": timings, "block_masks": block_masks}


CAPTION_K2_SHAPE = "B32 S120 Q120 H12 d64 bf16"
DECODE_K2_SHAPE = "B16 S120 Q120 H12 d64 bf16"


def k2_block_masks(gen, checks, max_err) -> dict:
    """K2's 2-D path (bias_q == S): against the plain versions at B 32 and
    the odd S 17 and 121 under random 2-D masks (a bias row 16-byte aligned
    only where S % 4 == 0), dropout 0 and 0.1; then at the captioning
    step's shape, B 32 rows, and the decoder's, B 16, of 40 caption slots +
    30 OD labels + 50 regions under per-row block masks
    (tasks/captioning.py::_decode_attention_mask, OD and region lengths
    drawn per row, their padded rows fully masked): forward and backward
    against the plain versions at dropout 0.1, then kernel (also at
    dropout 0), plain and scaled_dot_product_attention times (the same
    float mask, rate 0) beside the bound. Returns {shape: timings}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from aladin_torch.ops.kernels import attention_kernel as ak
    from aladin_torch.tasks.captioning import _decode_attention_mask

    h, d = 12, 64

    def qkvg(b, s):
        return (torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(4))

    def check(tag, q, k, v, g, bias, extra):
        want = ak.attention_forward_plain(q, k, v, bias, *extra)
        max_err["fwd"] = max(max_err["fwd"], check_close(
            checks, "K2 forward", f"{tag} ctx", ak.attention_forward(q, k, v, bias, *extra),
            want, BF16_ULP * want.float().abs().max().item()))
        for name, gt, wt in zip(("dq", "dk", "dv"),
                                ak.attention_backward(q, k, v, bias, g, *extra),
                                ak.attention_backward_plain(q, k, v, bias, g, *extra)):
            max_err["bwd"] = max(max_err["bwd"], check_close(
                checks, "K2 backward", f"{tag} {name}", gt, wt,
                BF16_ULP * wt.float().abs().max().item()))

    for s in (17, 121):
        q, k, v, g = qkvg(32, s)
        keep = torch.rand(32, s, s, generator=gen, device="cuda") > 0.2
        keep[0] = False  # a fully padded row stays finite (-10000, not -inf)
        for rate in (0.0, 0.1):
            check(f"B32 S{s} Q{s} rate{rate}", q, k, v, g, (~keep).float() * -10000.0,
                  (1000 + s, rate, True))

    out = {}
    for shape, b, mask_seed in ((CAPTION_K2_SHAPE, 32, 3), (DECODE_K2_SHAPE, 16, 4)):
        s = 120
        rng = np.random.RandomState(mask_seed)
        masks = np.stack([_decode_attention_mask(40, 70, 50, int(o), int(r)) for o, r in
                          zip(rng.randint(1, 31, b), rng.randint(10, 51, b))])
        bias = (1.0 - torch.from_numpy(masks).float().cuda()) * -10000.0  # (B, S, S)
        q, k, v, g = qkvg(b, s)
        extra = (torch.full((), 11, dtype=torch.int64, device="cuda"), 0.1, True)
        check(f"block masks B{b} S120 Q120", q, k, v, g, bias, extra)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask = bias[:, None].to(torch.bfloat16)  # (B, 1, S, S)
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        gt = g.transpose(1, 2)

        def sdpa_fwd(qt=qt, kt=kt, vt=vt, mask=mask):
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        res = {}
        for key, fn, plain, lib in (
                ("fwd", lambda: ak.attention_forward(q, k, v, bias, *extra),
                 lambda: ak.attention_forward_plain(q, k, v, bias, *extra), sdpa_fwd),
                ("bwd", lambda: ak.attention_backward(q, k, v, bias, g, *extra),
                 lambda: ak.attention_backward_plain(q, k, v, bias, g, *extra),
                 lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), gt, retain_graph=True))):
            bnd, by = attention_bound(b, s, h, d, s, key == "bwd")
            res[key] = {"ms": device_ms(fn, 20), "plain_ms": device_ms(plain, 5),
                        "library_ms": device_ms(lib, 20), "bound_ms": bnd, "bound_by": by}
            res[key]["bound_share"] = bnd / res[key]["ms"]
        # the kernel at dropout 0, as the library call runs
        res["fwd"]["ms_rate0"] = device_ms(
            lambda: ak.attention_forward(q, k, v, bias, 11, 0.0, True), 20)
        res["bwd"]["ms_rate0"] = device_ms(
            lambda: ak.attention_backward(q, k, v, bias, g, 11, 0.0, True), 20)
        del sdpa_out
        out[shape] = res
    return out


def phase_k3() -> dict:
    """K3a: the forward (Triton) and the backward kernel (CUDA) against the
    plain versions at M = 128 x 84 and 128 x 50 rows of D 768; then times."""
    import torch
    import torch.nn.functional as F

    from aladin_torch.ops.kernels import layernorm as lk

    gen = torch.Generator(device="cuda").manual_seed(3)
    d, eps = 768, 1e-12
    checks, max_err, timings = [], {"fwd": 0.0, "bwd": 0.0}, {}
    for s in (84, 50):
        m = 128 * s

        def randn(scale=1.0):
            return scale * torch.randn(m, d, generator=gen, device="cuda")

        x, res, gy = randn().to(torch.bfloat16), randn(0.5).to(torch.bfloat16), randn()
        gy = gy.to(torch.bfloat16)
        gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
        y, mean, rstd = lk.residual_layernorm_forward(x, res, gamma, beta, eps)
        wy, wmean, wrstd = lk.residual_layernorm_forward_plain(x, res, gamma, beta, eps)
        tag = f"M{m}"
        max_err["fwd"] = max(max_err["fwd"], check_close(
            checks, "K3a", tag + " y", y, wy, BF16_ULP * wy.float().abs().max().item()))
        check_close(checks, "K3a", tag + " mean", mean, wmean,
                    F32_SUM_RTOL * wmean.abs().max().item())
        check_close(checks, "K3a", tag + " rstd", rstd, wrstd,
                    F32_SUM_RTOL * wrstd.abs().max().item())

        # the backward kernel against its plain version (the torch ops it
        # replaces) and against autograd through the plain forward
        grads = lk.residual_layernorm_backward(x, res, gamma, mean, rstd, gy)
        plain = lk.residual_layernorm_backward_plain(x, res, gamma, mean, rstd, gy)
        leaves = [t.clone().requires_grad_() for t in (x, res, gamma, beta)]
        lk.residual_layernorm_plain(*leaves, eps).backward(gy)
        for name, got, want, auto in zip(("dx", "dres", "dgamma", "dbeta"), grads, plain,
                                         (t.grad for t in leaves)):
            for what, w in (("plain", want), ("autograd", auto)):
                rel = BF16_ULP if w.dtype == torch.bfloat16 else F32_SUM_RTOL
                err = check_close(checks, "K3a backward", f"{tag} {name} vs {what}", got, w,
                                  rel * w.float().abs().max().item())
                if what == "plain":
                    max_err["bwd"] = max(max_err["bwd"], err)
        again = lk.residual_layernorm_backward(x, res, gamma, mean, rstd, gy)
        if not (torch.equal(again[2], grads[2]) and torch.equal(again[3], grads[3])):
            raise AssertionError(f"K3a backward's dgamma / dbeta differ between two calls at {tag}")
        del grads, plain, again, leaves

        g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)
        lib = [t.clone().requires_grad_() for t in (x, res, g16, b16)]
        lib_out = F.layer_norm(lib[0] + lib[1], (d,), lib[2], lib[3], eps)
        bound_ms, bound_by = bound(3 * m * d * 2 + 2 * m * 4 + 2 * d * 4, 8.0 * m * d, "f32")
        # g, x, res read and dh written once (bf16), the statistics, gamma
        # read and dgamma / dbeta written; ~10 f32 operations an element
        bwd_bound_ms, bwd_bound_by = bound(4 * m * d * 2 + 2 * m * 4 + 3 * d * 4, 10.0 * m * d,
                                           "f32")
        timings[s] = {
            "ms": device_ms(lambda: lk.residual_layernorm_forward(x, res, gamma, beta, eps), 50),
            "event_ms": cuda_ms(
                lambda: lk.residual_layernorm_forward(x, res, gamma, beta, eps), 50),
            "plain_ms": device_ms(
                lambda: lk.residual_layernorm_forward_plain(x, res, gamma, beta, eps), 20),
            "library_ms": device_ms(lambda: F.layer_norm(x + res, (d,), g16, b16, eps), 50),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "backward_ms": device_ms(
                lambda: lk.residual_layernorm_backward(x, res, gamma, mean, rstd, gy), 50),
            "backward_event_ms": cuda_ms(
                lambda: lk.residual_layernorm_backward(x, res, gamma, mean, rstd, gy), 50),
            "backward_plain_ms": device_ms(
                lambda: lk.residual_layernorm_backward_plain(x, res, gamma, mean, rstd, gy), 20),
            "backward_library_ms": device_ms(
                lambda: torch.autograd.grad(lib_out, lib, gy, retain_graph=True), 50),
            "backward_bound_ms": bwd_bound_ms, "backward_bound_by": bwd_bound_by,
        }
        for key in ("", "backward_"):
            timings[s][key + "bound_share"] = timings[s][key + "bound_ms"] / timings[s][key + "ms"]
        del lib_out, lib
    emit({"phase": "k3", "checks": checks, "backward_dgamma_dbeta_bitwise_repeatable": True,
          "tolerance": "bf16 outputs max|want| * 2^-7 (one bf16 ulp); f32 sums 1e-4 of max|want|",
          "timings": {f"M{128 * s} D{d} bf16": t for s, t in timings.items()},
          "timing": "ms, plain_ms, library_ms and the backward's: card time (device_ms); "
                    "event_ms: CUDA events around back-to-back calls; backward_plain_ms: the "
                    "analytic backward in torch ops, as the port ran it before the kernel",
          "library": "F.layer_norm(x + res): two calls (the add, then the LayerNorm); "
                     "backward: torch.autograd.grad through them w.r.t. x, res, gamma, beta"})
    return {"max_err": max_err, "timings": timings}


class SmiSampler:
    """``nvidia-smi`` sampling the SM clock, power draw and power limit every
    100 ms while the ``with`` block runs; ``summary`` gives min / median /
    max of each over the samples."""

    FIELDS = ("clocks.sm", "power.draw", "power.limit")

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(self.FIELDS)}",
             "--format=csv,noheader,nounits", "-lms", "100", "-i", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        self.summary = {"samples": len(rows)}
        for i, name in enumerate(self.FIELDS):
            vals = sorted(r[i] for r in rows if len(r) == len(self.FIELDS))
            if vals:
                self.summary[name] = {"min": vals[0], "median": vals[len(vals) // 2],
                                      "max": vals[-1]}
        return False


def w8a8_bound(m: int, k: int, n: int, x_bytes: int, out_bytes: int = 2):
    """K4's least time: x (x_bytes a value; int8 x adds its f32 row scales),
    wq and the f32 weight scales and bias read once, y written once, against
    2*M*K*N int8 operations."""
    n_bytes = m * k * x_bytes + (4 * m if x_bytes == 1 else 0) + n * k + 8 * n + m * n * out_bytes
    return bound(n_bytes, 2.0 * m * k * n, "int8")


def phase_k4() -> dict:
    """K4 and K4-dynx against their plain versions at the encoder's shapes
    (M 2688 / 1600, the image and caption passes at bs 32, and M 7 / 37;
    K 768; N 2304 QKV, 3072 FFN-up with gelu, one gelu_tanh case; bf16 and
    f32 out; f32 without activation and the quantize bitwise); then times
    at M 2688 and 1600 beside bf16 F.linear, the quantize pass alone, and
    the card's clock and power."""
    import torch
    import torch.nn.functional as F

    from aladin_torch.ops.kernels import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(6)
    k = 768
    checks, max_err, timings, quantize = [], {"k4": 0.0, "k4_dynx": 0.0}, {}, {}
    cases = ((2304, None, "qkv"), (3072, "gelu", "ffn_up"), (2304, "gelu_tanh", "gelu_tanh"))
    for m in (2688, 1600, 7, 37):
        for n, act, label in cases:
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            wq, ws = qm.quantize_weight(0.03 * torch.randn(n, k, generator=gen, device="cuda"))
            b = 0.1 * torch.randn(n, generator=gen, device="cuda")
            xq, xs = qm.quantize_rowwise(x)
            for od in (torch.bfloat16, torch.float32):
                kw = {"activation": act, "out_dtype": od}
                for name, got, want in (
                        ("k4", qm.w8a8_matmul(xq, xs, wq, ws, b, **kw),
                         qm.w8a8_matmul_plain(xq, xs, wq, ws, b, **kw)),
                        ("k4_dynx", qm.w8a8_matmul_dynx(x, wq, ws, b, **kw),
                         qm.w8a8_matmul_dynx_plain(x, wq, ws, b, **kw))):
                    rel = (BF16_ULP if od == torch.bfloat16
                           else K4_F32_RTOL if act is None else K4_F32_ACT_RTOL)
                    tag = f"M{m} N{n} {act} {str(od)[6:]}"
                    max_err[name] = max(max_err[name], check_close(
                        checks, name, tag, got, want, rel * want.float().abs().max().item()))
                    if od == torch.float32 and act is None and not torch.equal(got, want):
                        raise AssertionError(f"{name} f32 without activation is not bitwise "
                                             f"equal to its plain version at {tag}")
            # the quantize kernel's q and scale equal the plain quantize
            # bitwise, and K4-dynx equals K4 fed with them
            xq2, xs2 = qm.quantize_rowwise_dynx(x)
            kq, ks = qm.w8a8_quantize(x)
            if not (torch.equal(kq, xq2) and torch.equal(ks, xs2)):
                raise AssertionError(f"the dynx quantize kernel differs at M{m}")
            got = qm.w8a8_matmul_dynx(x, wq, ws, b, out_dtype=torch.float32)
            if not torch.equal(got, qm.w8a8_matmul_plain(xq2, xs2, wq, ws, b,
                                                          out_dtype=torch.float32)):
                raise AssertionError(f"K4-dynx's quantize differs at M{m} N{n}")
            if m not in (2688, 1600) or act == "gelu_tanh":
                continue
            wt = wq.t()  # (K, N) column-major for torch._int_mm
            w16 = (wq.float() * ws[:, None]).to(torch.bfloat16)

            def epilogue(acc, scale, act=act):
                y = acc.float() * scale * ws + b
                return (F.gelu(y) if act else y).to(torch.bfloat16)

            def linear(act=act):
                y = F.linear(x, w16, b.to(torch.bfloat16))
                return F.gelu(y) if act else y

            def lib_dynx():
                q, sc = qm.quantize_rowwise_dynx(x)
                return epilogue(torch._int_mm(q, wt), sc)

            key = f"{label} M{m}"
            with SmiSampler() as smi:
                timings[key] = {"shape": f"M{m} K{k} N{n} {act} bf16 out",
                                "bf16_linear_ms": device_ms(linear, 50)}
                for name, fn, plain, lib, x_bytes in (
                        ("k4", lambda: qm.w8a8_matmul(xq, xs, wq, ws, b, activation=act),
                         lambda: qm.w8a8_matmul_plain(xq, xs, wq, ws, b, activation=act),
                         lambda: epilogue(torch._int_mm(xq, wt), xs), 1),
                        ("k4_dynx", lambda: qm.w8a8_matmul_dynx(x, wq, ws, b, activation=act),
                         lambda: qm.w8a8_matmul_dynx_plain(x, wq, ws, b, activation=act),
                         lib_dynx, 2)):
                    bound_ms, bound_by = w8a8_bound(m, k, n, x_bytes)
                    t = {"ms": device_ms(fn, 50), "plain_ms": device_ms(plain, 10),
                         "library_ms": device_ms(lib, 50), "bound_ms": bound_ms,
                         "bound_by": bound_by}
                    t["bound_share"] = bound_ms / t["ms"]
                    t["vs_bf16_linear"] = t["ms"] / timings[key]["bf16_linear_ms"]
                    timings[key][name] = t
            timings[key]["smi"] = smi.summary
            if label == "qkv":  # the quantize pass alone (its bytes: x read, xq and scales written)
                qb, qby = bound(m * k * 2 + m * k + m * 4, 0.0, "int8")
                quantize[f"M{m}"] = {"ms": device_ms(lambda: qm.w8a8_quantize(x), 50),
                                     "plain_ms": device_ms(lambda: qm.quantize_rowwise_dynx(x), 20),
                                     "bound_ms": qb, "bound_by": qby}
    emit({"phase": "k4", "checks": checks, "dynx_quantize_bitwise": True,
          "f32_no_activation_bitwise": True,
          "tolerance": "bf16 out: max|want| * 2^-7; f32 out: bitwise without activation, "
                       "1e-5 of max|want| with one",
          "timings": timings, "quantize_alone": quantize,
          "timing": "card time (device_ms); bound: bytes over 3.35 TB/s or 2MKN over 1979 TOP/s; "
                    "smi: nvidia-smi samples (MHz, W) over the timings of that shape",
          "library": "torch._int_mm + the descale, bias and gelu in torch ops (dynx: plus the "
                     "torch quantize); bf16_linear_ms: F.linear in bf16 (+ F.gelu)"})
    return {"max_err": max_err, "timings": timings}


def phase_k3b() -> dict:
    """K3b (CUDA) against its plain version at M 2688 and 1600 rows of 768,
    bf16 x and res; then times."""
    import torch
    import torch.nn.functional as F

    from aladin_torch.ops.kernels import layernorm as lk
    from aladin_torch.ops.kernels.quant_matmul import quantize_rowwise

    gen = torch.Generator(device="cuda").manual_seed(7)
    d, eps = 768, 1e-12
    checks, max_err, timings, q_share = [], 0.0, {}, {}
    for m in (2688, 1600):
        x = torch.randn(m, d, generator=gen, device="cuda").to(torch.bfloat16)
        res = (0.5 * torch.randn(m, d, generator=gen, device="cuda")).to(torch.bfloat16)
        gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
        y, q, s = lk.residual_layernorm_q8(x, res, gamma, beta, eps)
        wy, wq, ws = lk.residual_layernorm_q8_plain(x, res, gamma, beta, eps)
        tag = f"M{m}"
        max_err = max(max_err, check_close(checks, "K3b", tag + " y", y, wy,
                                           BF16_ULP * wy.float().abs().max().item()))
        check_close(checks, "K3b", tag + " s", s, ws, F32_SUM_RTOL * ws.abs().max().item())
        share = (q == wq).float().mean().item()
        step = (q.int() - wq.int()).abs().max().item()
        q_share[tag] = {"equal_share": share, "max_step": step}
        if share < K3B_Q_EQUAL_SHARE or step > 1:
            raise AssertionError(f"K3b's q disagrees with its plain version: {q_share[tag]}")
        g16, b16 = gamma.to(x.dtype), beta.to(x.dtype)
        bound_ms, bound_by = bound(3 * m * d * 2 + m * d + m * 4 + 2 * d * 4, 12.0 * m * d, "f32")
        timings[m] = {
            "ms": device_ms(lambda: lk.residual_layernorm_q8(x, res, gamma, beta, eps), 50),
            "plain_ms": device_ms(
                lambda: lk.residual_layernorm_q8_plain(x, res, gamma, beta, eps), 20),
            "library_ms": device_ms(
                lambda: quantize_rowwise(F.layer_norm(x + res, (d,), g16, b16, eps)), 50),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        timings[m]["bound_share"] = bound_ms / timings[m]["ms"]
    emit({"phase": "k3b", "checks": checks, "q": q_share,
          "tolerance": "y max|want| * 2^-7; s 1e-4 of max|want|; q equal in >= 99.9% and "
                       "at most one step apart",
          "timings": {f"M{m} D{d} bf16": t for m, t in timings.items()},
          "timing": "card time (device_ms)",
          "library": "F.layer_norm(x + res) then quantize_rowwise in torch ops (unfused)"})
    return {"max_err": max_err, "timings": timings}


def flagship_train_model(fused: bool, dropout: float, state_dict=None, remat: bool = False,
                         model_over=None, training_over=None):
    """(cfg, ALADIN on the card in train mode): the flagship recipe at bs 128
    and VinVL-base width, as benchmarks/train_bench.py builds it, with both
    kernel knobs set to ``fused``; random weights from a seed unless
    ``state_dict`` is given. ``remat``: BertImgConfig.remat;
    ``model_over`` / ``training_over``: more recipe keys (a variant, a
    memory lever)."""
    import torch

    from aladin_torch.config import ExperimentConfig
    from aladin_torch.models.aladin import ALADIN
    from aladin_torch.models.bert_img import BertImgConfig

    with open(os.path.join(ROOT, "aladin_torch", "configs", RECIPE)) as f:
        recipe = json.load(f)
    recipe["training"].update({"bs": 128, **(training_over or {})})
    recipe["model"].update({"dropout": dropout, **(model_over or {})})
    cfg = ExperimentConfig.from_dict(recipe)
    bert_cfg = BertImgConfig(fused_attention=fused, fused_layernorm=fused, remat=remat,
                             hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    model = ALADIN(cfg, bert_cfg)
    if state_dict is None:
        model.reset_parameters(torch.Generator().manual_seed(4321))
    else:
        model.load_state_dict(state_dict)
    return cfg, model.cuda().train()


def synth_train_batch(b: int, l: int = 50, r: int = 34, feat_dim: int = 2054,
                      vocab: int = 30522, seed: int = 5):
    """A random disentangled batch on the card (benchmarks/
    retrieval_eval_bench.py::synth_batch's distributions)."""
    import torch

    from aladin_torch.models.aladin import Batch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

    cap_len, img_len, lab_len = ints(8, l + 1, (b,)), ints(4, r + 1, (b,)), ints(4, l + 1, (b,))
    pos_l, pos_r = torch.arange(l, device="cuda")[None], torch.arange(r, device="cuda")[None]
    return Batch(
        txt_ids=ints(3, vocab, (b, l)), txt_mask=(pos_l < cap_len[:, None]).int(),
        txt_type=torch.zeros(b, l, dtype=torch.int32, device="cuda"), cap_len=cap_len,
        img_ids=ints(3, vocab, (b, l)),
        img_mask=torch.cat([pos_l < lab_len[:, None], pos_r < img_len[:, None]], dim=1).int(),
        img_type=torch.ones(b, l, dtype=torch.int32, device="cuda"),
        img_feats=torch.randn(b, r, feat_dim, generator=gen, device="cuda"), img_len=img_len)


# the train step's kernels as the profiler names them (K2 forward and
# backward, K3a's Triton forward, K3a's backward row pass; the backward's
# second launch, sum_partials, is not counted, as its wrapper counts once)
STEP_KERNELS = {"k2_fwd": "attn_fwd", "k2_bwd": "attn_bwd", "k3a": "rln_fwd",
                "k3a_bwd": "rln_bwd"}
GRAPH_K = 8  # steps a window in train_graph and the train_cli window run
# the step kernels' launch counters in utils/profiling.py, by this script's keys
K1_COUNTER = {"k1": "k1.launches"}
STEP_COUNTERS = {"k2_fwd": "k2.fwd_launches", "k2_bwd": "k2.bwd_launches",
                 "k3a": "k3a.fwd_launches", "k3a_bwd": "k3a.bwd_launches"}


def launch_counts(names: dict) -> dict:
    """{key: the value of the counter ``names[key]`` of utils/profiling.py}."""
    from aladin_torch.utils import profiling

    now = profiling.counters()
    return {k: now[n] for k, n in names.items()}


def launches_since(before: dict, names: dict) -> dict:
    """The counters ``names`` less their values in ``before``."""
    return {k: v - before[k] for k, v in launch_counts(names).items()}


# torch.profiler (torch 2.11, CUDA 12.8) loses the first device records of a
# trace, and more of them with every trace the process has taken: a B 128
# eager window's first K2 forward was its 24th kernel record in a fresh
# process and was lost after ~27 traces (PERF.md §6). device_profile
# therefore starts each trace with PROFILE_PAD spin kernels of ~10 us each
# and requires that some of them were recorded: what was lost lies in the
# pad, before the calls it measures.
PROFILE_PAD = 512
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def device_profile(fn, n: int, top: int = 12) -> dict:
    """torch.profiler over ``n`` calls of ``fn``, after the pad: per call,
    the wall ms under the profiler, the device ms (the sum of the device-side
    events' times: kernels, copies, fills; one stream, so they do not
    overlap), and the ``top`` device events by time. Raises if the trace
    kept none of the pad's kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(20_000)  # cycles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    pad = sum(e.count for e in events if PAD_KERNEL in e.key)
    if not pad:
        raise RuntimeError(f"the profiler kept none of the {PROFILE_PAD} pad kernels: records "
                           f"of the measured calls may be lost")
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / n, e.count / n) for e in events
                   if e.self_device_time_total > 0 and PAD_KERNEL not in e.key
                   and not getattr(e, "is_user_annotation", False)),  # spans, not work
                  key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_ms": sum(r[1] for r in rows), "pad_kept": pad,
            # the step kernels by name: a CUDA graph's replay shows its kernels
            # too, where the Python launch counters see only the capture
            "step_kernels": {k: sum(r[2] for r in rows if pat in r[0])
                             for k, pat in STEP_KERNELS.items()},
            "top": [{"name": name[:80], "ms": ms, "calls": calls} for name, ms, calls in rows[:top]]}


def phase_train_fused() -> dict:
    """The train step with K2 and K3a engaged at B 128 (the path that runs
    them), then knobs on vs off at dropout 0."""
    import torch

    from aladin_torch.ops.kernels import layernorm as lk
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_train_step

    batch = synth_train_batch(128)

    def run_steps(step, state, n):
        """(per-step metric dicts on the host, per-step ms)."""
        out, ms = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch, 0)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            out.append({k: v.item() for k, v in m.items()})
        return out, ms

    cfg, model = flagship_train_model(True, 0.1)
    state = TrainState(cfg, model, steps_per_epoch=100)
    n_steps = 4
    # the backward's torch ops (its plain version) must not run on this path
    plain_bwd, plain_calls = lk.residual_layernorm_backward_plain, []

    def counted_plain_bwd(*args):
        plain_calls.append(1)
        return plain_bwd(*args)

    before = launch_counts(STEP_COUNTERS)
    lk.residual_layernorm_backward_plain = counted_plain_bwd
    try:
        metrics, ms = run_steps(make_train_step(model, cfg, torch.bfloat16), state, n_steps)
    finally:
        lk.residual_layernorm_backward_plain = plain_bwd
    launches = launches_since(before, STEP_COUNTERS)
    layers = model.oscar_model.bert.cfg.num_hidden_layers
    want = {"k2_fwd": n_steps * 2 * layers, "k2_bwd": n_steps * 2 * layers,
            "k3a": n_steps * 2 * 2 * layers,  # 2 passes; 2 LayerNorms a layer
            "k3a_bwd": n_steps * 2 * 2 * layers}
    if launches != want or plain_calls:
        raise AssertionError(f"train step launches {launches} and {len(plain_calls)} torch-ops "
                             f"LayerNorm backwards, expected {want} and none")
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite train metrics: {metrics}")
    del model, state

    # knobs on vs off from the same params and batch at dropout 0
    cfg0, on = flagship_train_model(True, 0.0)
    _, off = flagship_train_model(False, 0.0, on.state_dict())
    pair = {"on": (on, TrainState(cfg0, on, steps_per_epoch=100)),
            "off": (off, TrainState(cfg0, off, steps_per_epoch=100))}
    steps = {k: make_train_step(m, cfg0, torch.bfloat16) for k, (m, _) in pair.items()}
    first = {k: run_steps(steps[k], pair[k][1], 1)[0][0] for k in ("on", "off")}
    agree = {
        "loss_rel_diff": abs(first["on"]["loss"] - first["off"]["loss"]) / abs(first["off"]["loss"]),
        "grad_norm_rel_diff": abs(first["on"]["grad_norm"] - first["off"]["grad_norm"])
        / abs(first["off"]["grad_norm"]),
    }
    if not (agree["loss_rel_diff"] <= KNOB_LOSS_RTOL
            and agree["grad_norm_rel_diff"] <= KNOB_GNORM_RTOL):
        raise AssertionError(f"knobs on vs off disagree: {first} {agree}")
    step_ms = {"on": [], "off": []}
    for k in ("on", "off", "off", "on"):  # in turns
        step_ms[k] += run_steps(steps[k], pair[k][1], 2)[1]
    mean_ms = {k: sum(v) / len(v) for k, v in step_ms.items()}
    profiles = {k: device_profile(lambda k=k: steps[k](pair[k][1], batch, 0), 2)
                for k in ("on", "off")}
    emit({"phase": "train_fused", "batch": 128, "steps": n_steps, "launches": launches,
          "torch_ops_layernorm_backwards": len(plain_calls),
          "metrics_last": metrics[-1], "step_ms_dropout0.1_on": ms,
          "knob_check_dropout0": {"first_step": first, **agree, "loss_rtol": KNOB_LOSS_RTOL,
                                  "grad_norm_rtol": KNOB_GNORM_RTOL},
          "step_ms_dropout0": mean_ms,
          # the profiler slows the host, so the busy share is taken against
          # the unprofiled step time
          "device_busy_share_dropout0": {k: profiles[k]["device_ms"] / mean_ms[k]
                                         for k in mean_ms},
          "device_profile_dropout0": profiles,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return {"launches": launches}


TP = 2  # tensor-parallel ranks of the tensor_parallel phase: two processes on the one card
TP_SEED = 99  # the generators' seed of both tensor_parallel runs (dp index 0 keeps it)
TP_FORWARD_ATOL = 1e-4  # f32 eval forward, tp run's weights in a tp = 1 model vs the tp model
# the partial product on the tensor cores against the upcast f32 product:
# both sum in f32, in other orders, over K <= 1536 terms
ROW_PARTIAL_RTOL = 1e-4
# one parameter's gathered tp gradient against the one-process gradient, by
# L2: within TP_LEAF_GRAD_RTOL of its own norm plus its size's share of the
# overall limit (KNOB_GNORM_RTOL |g| sqrt(numel / all)), which covers a
# leaf whose gradient is small; a gradient that misses a tp rank's share is
# off by about half of itself. The attention key biases are left to the
# overall check: softmax ignores a constant added to a row, so their
# gradients are zero but for rounding (1.4-1.6 of themselves apart)
TP_LEAF_GRAD_RTOL = 0.25


def k2_local_heads() -> dict:
    """K2 on one tensor-parallel rank's heads (B 128, S 84, bf16): at H 6,
    heads 6-11 of 12 (head_offset 6), forward and backward at dropout 0.1
    against the plain version (one bf16 ulp) and against the heads 6-11
    slice of an H 12 launch on the same q, k, v, g, bias and seed (bit for
    bit: a block computes one head, and the hash reads the global head);
    then at H 6 and H 3 (tp 2 and 4) the kernel's card time at dropout 0.1
    and 0, the plain version's, the bound and SDPA's on the same heads."""
    import torch
    import torch.nn.functional as F

    from aladin_torch.ops.kernels import attention_kernel as ak

    gen = torch.Generator(device="cuda").manual_seed(6)
    b, s, h, d = 128, 84, 12, 64
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(4))
    lens = torch.randint(4, s + 1, (b,), generator=gen, device="cuda")
    bias = (torch.arange(s, device="cuda")[None] >= lens[:, None])[:, None, :].float() * -10000.0
    seed = torch.full((), 11, dtype=torch.int64, device="cuda")
    full = ak.attention_forward(q, k, v, bias, seed, 0.1, True)
    full_g = ak.attention_backward(q, k, v, bias, g, seed, 0.1, True)
    sl = slice(6, 12)
    part = [t[:, :, sl].contiguous() for t in (q, k, v, g)]
    kw = dict(heads_total=h, head_offset=6)
    got = ak.attention_forward(*part[:3], bias, seed, 0.1, True, **kw)
    got_g = ak.attention_backward(*part[:3], bias, part[3], seed, 0.1, True, **kw)
    checks, max_err = [], {"fwd": 0.0, "bwd": 0.0}
    want = ak.attention_forward_plain(*part[:3], bias, seed, 0.1, True, **kw)
    max_err["fwd"] = check_close(checks, "K2 forward at head_offset 6", "H6 of 12 ctx", got, want,
                                 BF16_ULP * want.float().abs().max().item())
    for name, gt, wt in zip(("dq", "dk", "dv"), got_g, ak.attention_backward_plain(
            *part[:3], bias, part[3], seed, 0.1, True, **kw)):
        max_err["bwd"] = max(max_err["bwd"], check_close(
            checks, "K2 backward at head_offset 6", f"H6 of 12 {name}", gt, wt,
            BF16_ULP * wt.float().abs().max().item()))
    slice_bitwise = bool(torch.equal(got, full[:, :, sl])) and all(
        torch.equal(a, w[:, :, sl]) for a, w in zip(got_g, full_g))
    if not slice_bitwise:
        raise AssertionError("K2 at H 6, head_offset 6 differs from heads 6-11 of the H 12 launch")

    timings = {}
    for tp in (2, 4):
        hl = h // tp
        args = [t[:, :, :hl].contiguous() for t in (q, k, v, g)]
        kw = dict(heads_total=h, head_offset=hl)  # the second rank's heads
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in args[:3])
        mask = bias[:, None].to(torch.bfloat16)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        gt = args[3].transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        fwd_bound, fwd_by = attention_bound(b, s, hl, d, 1, False)
        bwd_bound, bwd_by = attention_bound(b, s, hl, d, 1, True)
        def fwd(rate, fn=ak.attention_forward):
            return fn(*args[:3], bias, seed, rate, True, **kw)

        def bwd(rate, fn=ak.attention_backward):
            return fn(*args[:3], bias, args[3], seed, rate, True, **kw)

        timings[f"B{b} S{s} H{hl} of {h} d{d} bf16"] = {
            "fwd": {"ms": device_ms(lambda: fwd(0.1), 20),
                    "ms_rate0": device_ms(lambda: fwd(0.0), 20),
                    "plain_ms": device_ms(lambda: fwd(0.1, ak.attention_forward_plain), 5),
                    "library_ms": device_ms(sdpa_fwd, 20), "bound_ms": fwd_bound,
                    "bound_by": fwd_by},
            "bwd": {"ms": device_ms(lambda: bwd(0.1), 20),
                    "ms_rate0": device_ms(lambda: bwd(0.0), 20),
                    "plain_ms": device_ms(lambda: bwd(0.1, ak.attention_backward_plain), 5),
                    "library_ms": device_ms(lambda: torch.autograd.grad(
                        out, (qt, kt, vt), gt, retain_graph=True), 20),
                    "bound_ms": bwd_bound, "bound_by": bwd_by}}
        del out
    for t in timings.values():
        for x in t.values():
            x["bound_share"] = x["bound_ms"] / x["ms"]
    return {"checks": checks, "max_err": max_err, "slice_of_h12_launch_bitwise": slice_bitwise,
            "timings": timings}


def tp_rank_main(rank: int, port: int, work: str) -> int:
    """One rank of the tensor_parallel phase (``chip_smoke.py --tp-rank R
    --tp-port P --tp-work DIR``): joins a 2-rank gloo group, builds the
    flagship model from the phase's weights, shards it over dp=1,tp=2 and
    runs its steps (module docstring of phase_tensor_parallel); rank 0
    writes its results to ``<work>/rank0.pt``, rank 1 its launch counts."""
    sys.path.insert(0, ROOT)
    import torch

    from aladin_torch.data.pipeline import BatchLoader
    from aladin_torch.models.aladin import Batch
    from aladin_torch.parallel.distributed import initialize, shutdown
    from aladin_torch.parallel.mesh import create_mesh
    from aladin_torch.parallel.sharding import full_state_dict, gather_tensor, is_sharded
    from aladin_torch.cli.common import shard_state_and_loaders
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    # gloo: the one card cannot hold two NCCL ranks; gloo reduces and
    # broadcasts CUDA tensors, and the gathers go through host memory
    initialize(f"127.0.0.1:{port}", num_processes=TP, process_id=rank, device="cpu")
    try:
        mesh = create_mesh(f"dp=1,tp={TP}", device="cuda")
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
        batch = Batch(**{f: v.cuda() for f, v in inp["batch"].items()})
        out = {"launches": {}, "metrics": {}, "host_ms_per_step": None}

        def sharded(dropout, head_dropout):
            cfg, model = flagship_train_model(True, dropout, inp["start"],
                                              model_over={"dropout": head_dropout})
            state = TrainState(cfg, model, steps_per_epoch=100)
            shard_state_and_loaders(state, mesh, cfg, TP_SEED, BatchLoader(range(128), 128))
            return cfg, model, state

        for tag, dropout in (("dropout0", 0.0), ("dropout0.1", 0.1)):
            cfg, model, state = sharded(dropout, 0.0)
            step = make_train_step(model, cfg, torch.bfloat16, mesh)
            before = launch_counts(STEP_COUNTERS)
            metrics = {k: v.item() for k, v in step(state, batch, 0).items()}
            out["launches"][tag] = launches_since(before, STEP_COUNTERS)
            out["metrics"][tag] = metrics
            # the step's gradients (after the clip), gathered to full shapes
            grads = {n: gather_tensor(p.grad, p.tp_kind, mesh) if is_sharded(p) else p.grad
                     for n, p in model.named_parameters() if p.grad is not None}
            full = full_state_dict(model, mesh)
            if rank == 0:
                out[f"params_{tag}"] = {k: v.detach().cpu() for k, v in full.items()}
                out[f"grads_{tag}"] = {k: v.cpu() for k, v in grads.items()}
            del grads
            if tag == "dropout0":
                # ms a step on the card's two ranks (both run every step), by
                # the host's clock and by CUDA events on the card's stream;
                # no profiler here: the parent process traces the card
                torch.cuda.synchronize()
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                for _ in range(2):
                    step(state, batch, 0)
                stop.record()
                torch.cuda.synchronize()
                out["host_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / 2
                out["card_clock_ms_per_step"] = start.elapsed_time(stop) / 2
                # the f32 eval forward of the tp model, for the tp = 1 check
                model.eval()
                with torch.no_grad():
                    rows = Batch(**{f: getattr(batch, f)[:32] for f in Batch.__dataclass_fields__})
                    fwd = model(rows)
                out["eval_forward"] = {"img_global": fwd.img_global.cpu(),
                                       "cap_global": fwd.cap_global.cpu(),
                                       "img_set": fwd.img_set.cpu()}
                out["params_for_forward"] = {k: v.detach().cpu() for k, v in
                                             full_state_dict(model, mesh).items()}
            del model, state, step
        torch.save(out if rank == 0 else {"launches": out["launches"]},
                   os.path.join(work, f"rank{rank}.pt"))
    finally:
        shutdown()
    return 0


def row_partial_product_check() -> dict:
    """The row-parallel layers' partial product at a tp = 2 rank's shapes
    (M 10752 = B 128 x S 84; K 384 of attention-out, 1536 of FFN-down; N
    768): bf16 operands with an f32 result on the tensor cores
    (``parallel/sharding.py::_PartialProduct``) against the f32 product of
    the upcast operands (f32 sums in another order: within
    ROW_PARTIAL_RTOL of the largest |h| |w|^T entry), and the card ms of
    each."""
    import torch

    from aladin_torch.parallel.sharding import _PartialProduct

    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    for what, k in (("attention-out", 384), ("ffn-down", 1536)):
        h = torch.randn(10752, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(768, k, generator=gen, device="cuda") / k ** 0.5).to(torch.bfloat16)
        got = _PartialProduct.apply(h, w)
        want = h.float() @ w.float().t()
        scale = float((h.float().abs() @ w.float().abs().t()).max())
        err = float((got - want).abs().max())
        if got.dtype != torch.float32 or not err <= ROW_PARTIAL_RTOL * scale:
            raise AssertionError(f"row-parallel partial product {what}: {got.dtype}, max abs "
                                 f"diff {err} > {ROW_PARTIAL_RTOL} x {scale}")
        out[f"M10752 K{k} N768 ({what})"] = {
            "max_abs_diff": err, "tol": ROW_PARTIAL_RTOL * scale,
            "bf16_in_f32_out_ms": device_ms(lambda: _PartialProduct.apply(h, w), 20),
            "f32_upcast_ms": device_ms(lambda: h.float() @ w.float().t(), 20)}
    return out


def phase_tensor_parallel(tmp: str) -> dict:
    """Tensor parallelism on the card: two processes, each one rank of a
    dp=1,tp=2 mesh over gloo on the one card (NCCL refuses two ranks on one
    device; gloo's all-reduce and broadcast take CUDA tensors, the only
    collectives a dp = 1 step needs, and the mesh's gathers go through host
    memory). This is a way to run two ranks on one card, not a fallback:
    the CLIs keep NCCL, one rank a card. The flagship model at VinVL-base
    width, B 128, bf16, K2 and K3a on, each rank with heads [6 t, 6 t + 6)
    of every layer:

      * one eager step against the one-process step from the same weights
        and batch at dropout 0: loss and grad_norm within KNOB_LOSS_RTOL /
        KNOB_GNORM_RTOL, the gradients gathered to full shapes within
        KNOB_GNORM_RTOL (relative L2 over all of them) and each within its
        limit (TP_LEAF_GRAD_RTOL), every parameter after the step
        within what one Adam step allows (2 lr, plus four f32 roundings of
        the largest parameter);
      * the same at dropout 0.1 in the backbone (the heads' dropout 0: its
        plain dropouts on sharded activations draw other masks than tp = 1
        by design), both runs' generators seeded alike: K2 hashes the global
        head, so its masks are the tp = 1 masks;
      * exactly 24 / 24 K2 and 48 / 48 K3a launches a rank a step;
      * host ms a step and the card's clock (CUDA events) a step, beside
        the one-process step's host and profiled card ms (the ranks run no
        profiler);
      * the gathered weights loaded into a tp = 1 model give the tp model's
        f32 eval forward (TP_FORWARD_ATOL);
      * K2 at one rank's heads (``k2_local_heads``), and the row-parallel
        partial product (``row_partial_product_check``)."""
    import torch

    from aladin_torch.models.aladin import Batch
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_train_step

    k2 = k2_local_heads()
    work = os.path.join(tmp, "tp")
    os.makedirs(work, exist_ok=True)
    cfg, model = flagship_train_model(True, 0.0)
    start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    batch = synth_train_batch(128, seed=21)
    torch.save({"start": start, "batch": {f: getattr(batch, f).cpu()
                                          for f in Batch.__dataclass_fields__}},
               os.path.join(work, "inputs.pt"))
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
                               "--tp-port", str(port), "--tp-work", work],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(TP)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"tensor_parallel rank {r} failed:\n{log[-3000:]}")
    got = torch.load(os.path.join(work, "rank0.pt"), weights_only=False)
    rank1 = torch.load(os.path.join(work, "rank1.pt"), weights_only=False)
    layers = 12
    want_launches = {"k2_fwd": 2 * layers, "k2_bwd": 2 * layers, "k3a": 4 * layers,
                     "k3a_bwd": 4 * layers}
    for r, res in enumerate((got, rank1)):
        for tag, launches in res["launches"].items():
            if launches != want_launches:
                raise AssertionError(f"tp rank {r} {tag}: launches {launches} != {want_launches}")

    # the one-process steps from the same weights and batch
    out = {"card": nvidia_smi_line(), "mesh": f"dp=1,tp={TP}", "backend": "gloo",
           "torch": torch.__version__, "ranks_seconds": ranks_s, "k2_local_heads": k2,
           "launches_per_rank_step": got["launches"]["dropout0"], "comparisons": {}}
    lr = cfg.training.lr
    for tag, dropout in (("dropout0", 0.0), ("dropout0.1", 0.1)):
        cfg1, one = flagship_train_model(True, dropout, start, model_over={"dropout": 0.0})
        state = TrainState(cfg1, one, steps_per_epoch=100)
        torch.manual_seed(TP_SEED)
        step = make_train_step(one, cfg1, torch.bfloat16)
        want = {k: v.item() for k, v in step(state, batch, 0).items()}
        tp_m = got["metrics"][tag]
        params = got[f"params_{tag}"]
        grads = {n: p.grad for n, p in one.named_parameters() if p.grad is not None}
        if set(grads) != set(got[f"grads_{tag}"]):
            raise AssertionError(f"tp step {tag}: gradients of other parameters than the "
                                 f"one-process step's")
        # |g_tp - g_one|^2 and |g_one|^2 of each parameter's gradient (L2)
        sq = {n: (float((got[f"grads_{tag}"][n].cuda() - g).float().norm()) ** 2,
                  float(g.float().norm()) ** 2, g.numel()) for n, g in grads.items()}
        total_d, total_w = sum(v[0] for v in sq.values()), sum(v[1] for v in sq.values())
        total_n = sum(v[2] for v in sq.values())
        # each leaf against its limit (TP_LEAF_GRAD_RTOL), the key biases left to the sum
        leaf = sorted(((d ** 0.5 / (TP_LEAF_GRAD_RTOL * w ** 0.5 + KNOB_GNORM_RTOL * (
            total_w * k / total_n) ** 0.5), n, (d / w) ** 0.5 if w else None)
            for n, (d, w, k) in sq.items() if not n.endswith("attention.self.key.bias")),
            key=lambda r: -r[0])
        agree = {
            "loss_rel_diff": abs(tp_m["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_norm_rel_diff": abs(tp_m["grad_norm"] - want["grad_norm"]) / want["grad_norm"],
            "grad_rel_l2_diff": (total_d / total_w) ** 0.5,
            "grad_leaf_share_of_limit_max": leaf[0][0],
            "grad_leaf_worst": [{"name": n, "share_of_limit": r, "rel_l2_diff": rel}
                                for r, n, rel in leaf[:4]],
            "key_bias_rel_l2_diff_max": max(((d / w) ** 0.5 for n, (d, w, _) in sq.items()
                                             if n.endswith("attention.self.key.bias") and w),
                                            default=None),
            "param_max_abs_diff": max(float((params[k].cuda() - v).abs().max())
                                      for k, v in one.state_dict().items()),
            # one Adam step from one state moves a parameter by at most lr
            # either way; the f32 parameter rounds after it (2^-23 of |p|)
            "param_bound": 2 * lr * 1.001 + 2.0 ** -21 * max(
                float(v.abs().max()) for v in start.values()),
            "tp": tp_m, "one_process": want}
        if set(params) != set(one.state_dict()) or any(
                tuple(params[k].shape) != tuple(v.shape) for k, v in one.state_dict().items()):
            raise AssertionError("the gathered state dict differs from a one-process model's "
                                 "keys or shapes")
        if not (agree["loss_rel_diff"] <= KNOB_LOSS_RTOL
                and agree["grad_norm_rel_diff"] <= KNOB_GNORM_RTOL
                and agree["grad_rel_l2_diff"] <= KNOB_GNORM_RTOL
                and agree["grad_leaf_share_of_limit_max"] <= 1.0
                and agree["param_max_abs_diff"] <= agree["param_bound"]):
            raise AssertionError(f"tp step {tag} against the one-process step: {agree}")
        out["comparisons"][tag] = agree
        if tag == "dropout0":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                step(state, batch, 0)
            torch.cuda.synchronize()
            out["one_process_host_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / 3
            out["one_process_card_ms_per_step"] = device_profile(
                lambda: step(state, batch, 0), 2, top=0)["device_ms"]
        del one, state, step, grads
    out["tp_host_ms_per_step"] = got["host_ms_per_step"]
    out["tp_card_clock_ms_per_step_rank0"] = got["card_clock_ms_per_step"]
    out["row_partial_product"] = row_partial_product_check()

    # the tp run's gathered weights in a tp = 1 model: the same f32 forward
    _, one = flagship_train_model(True, 0.0, {k: v.cuda() for k, v in
                                              got["params_for_forward"].items()})
    one.eval()
    with torch.no_grad():
        rows = Batch(**{f: getattr(batch, f)[:32] for f in Batch.__dataclass_fields__})
        fwd = one(rows)
    err = max(float((getattr(fwd, k).cpu() - v).abs().max())
              for k, v in got["eval_forward"].items())
    out["tp1_forward_max_abs_diff"] = err
    if not err <= TP_FORWARD_ATOL:
        raise AssertionError(f"the tp run's weights in a tp = 1 model: forward differs by {err}")
    del one
    emit({"phase": "tensor_parallel", **out})
    return {"launches": got["launches"]["dropout0"], "k2": k2}


# PyTorch's embedding backward on the card takes a direct, deterministic
# path up to this many indices and past it sums rows with atomics. The
# token-type rows (every caption token is type 0, every image-pass text token
# type 1) summed that way until their lookup became a chain of selects with
# a fixed-order gradient (models/bert_img.py::select_rows); past this many
# indices train_graph still checks the step with the table frozen too.
EMBEDDING_DIRECT_INDICES = 3072
# the graphed window's metrics against the eager steps' past that many
# indices, kept beside the bitwise check: with the atomic sum, 8 eager steps
# repeated differed by up to ~1.5e-3 relative in loss and grad_norm
GRAPH_NONDET_RTOL = 1e-2


def train_graph_at(b: int, check_dropout: bool) -> dict:
    """The flagship step at batch ``b``, knobs on, dropout 0: one graphed
    window of 8 against 8 eager steps from the same state, params, Adam
    moments and metrics bit for bit. Past 3072 token ids (B x 50), where
    PyTorch's embedding backward would sum the token-type rows with atomics,
    the bitwise check also runs with the token-type table frozen, after two
    eager runs show the step then repeats itself bit for bit, and the full
    step's graphed metrics are held to GRAPH_NONDET_RTOL of the eager ones
    besides bit for bit. Then, on the
    full step, host-clock ms a step over 4 windows each, the profiler's card
    ms, busy share and kernels a step by name, peak memory; with
    ``check_dropout``, at dropout 0.1 the seeds of two replays and the
    losses against eager from one generator state."""
    import gc

    import torch

    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_multi_train_step, make_train_step

    k, windows = GRAPH_K, 4
    batches = [synth_train_batch(b, seed=10 + i) for i in range(k)]
    atomic = b * batches[0].txt_ids.shape[1] > EMBEDDING_DIRECT_INDICES
    out = {"batch": b, "k": k}

    def host_ms(fn):
        fn()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(windows):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (windows * k)

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def build(start, freeze_token_types=False):
        _, model = flagship_train_model(True, 0.0, start)
        if freeze_token_types:
            model.oscar_model.bert.embeddings.token_type_embeddings.weight.requires_grad_(False)
        return model, TrainState(cfg, model, steps_per_epoch=100)

    def snapshot(state, rows):
        """(stacked metrics, the trainable params and Adam moments, cloned)."""
        metrics = {n: torch.stack([m[n] for m in rows]).reshape(-1) for n in rows[0]}
        tensors = [p.detach().clone() for p in state.trainable]
        tensors += [v.clone() for p in state.trainable
                    for v in state.optimizer.state.get(p, {}).values()]
        return metrics, tensors

    def eager_run(start, freeze=False):
        model, state = build(start, freeze)
        step = make_train_step(model, cfg, torch.bfloat16)
        torch.cuda.manual_seed(1)
        return model, state, step, snapshot(state, [step(state, x, 0) for x in batches])

    def graph_run(start, freeze=False):
        model, state = build(start, freeze)
        multi = make_multi_train_step(model, cfg, torch.bfloat16, k=k)
        torch.cuda.manual_seed(1)
        t0 = time.perf_counter()
        got = snapshot(state, [multi(state, batches, 0)])
        torch.cuda.synchronize()
        return model, state, multi, got, time.perf_counter() - t0

    def bitwise(a, c):
        return all(torch.equal(a[0][n], c[0][n]) for n in a[0]) and len(a[1]) == len(c[1]) \
            and all(torch.equal(x, y) for x, y in zip(a[1], c[1]))

    fresh()
    cfg, model = flagship_train_model(True, 0.0)
    start = {n: v.detach().clone() for n, v in model.state_dict().items()}
    del model

    # 1. bit for bit: the graph replays the eager step's kernels
    want = eager_run(start, atomic)[3]
    if atomic and not bitwise(want, eager_run(start, True)[3]):
        raise AssertionError(f"B {b}: with the token-type table frozen the eager step still "
                             f"does not repeat itself bit for bit")
    got = graph_run(start, atomic)[3]
    if not bitwise(want, got):
        diff = [n for n in want[0] if not torch.equal(want[0][n], got[0][n])]
        raise AssertionError(f"B {b}: the graphed window of {k} differs from {k} eager steps "
                             f"(metrics {diff}, {sum(not torch.equal(x, y) for x, y in zip(want[1], got[1]))} "
                             f"tensors){' with the token-type table frozen' if atomic else ''}")
    out["graph_equals_eager_bitwise"] = {
        "metrics": len(want[0]), "tensors": len(want[1]),
        "token_type_table": "frozen (past 3072 ids)" if atomic else "trained"}
    del want, got
    fresh()


    # 2. the full step: eager timing, then the graph's
    model, eager, step, want = eager_run(start)

    def eager_window():
        for x in batches:
            step(eager, x, 0)

    out["eager_ms_per_step"] = host_ms(eager_window)
    out["eager_profile"] = device_profile(eager_window, 1, top=0)
    out["eager_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, eager, step, eager_window
    fresh()
    model, graphed, multi, got, out["capture_and_first_replay_s"] = graph_run(start)
    rel = {n: float(((got[0][n] - want[0][n]).abs() / want[0][n].abs().clamp_min(1e-30)).max())
           for n in want[0]}
    out["graph_vs_eager_metrics_rel_diff"] = rel
    if atomic and max(rel.values()) > GRAPH_NONDET_RTOL:
        raise AssertionError(f"B {b}: graphed metrics differ from eager by {rel}, beyond "
                             f"{GRAPH_NONDET_RTOL}")
    if not bitwise(want, got):
        raise AssertionError(f"B {b}: the full graphed step differs from eager: {rel}")
    out["full_graph_equals_eager_bitwise"] = True
    del want, got
    before = launch_counts(STEP_COUNTERS)
    out["graph_ms_per_step"] = host_ms(lambda: multi(graphed, batches, 0))
    if any(launches_since(before, STEP_COUNTERS).values()):
        raise AssertionError("a replay called a kernel wrapper from Python")
    out["graph_profile"] = device_profile(lambda: multi(graphed, batches, 0), 1, top=0)
    out["graph_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    layers = model.oscar_model.bert.cfg.num_hidden_layers
    want = {"k2_fwd": 2 * layers, "k2_bwd": 2 * layers, "k3a": 4 * layers, "k3a_bwd": 4 * layers}
    for mode in ("eager", "graph"):  # one window profiled: per step, / k
        prof = out.pop(f"{mode}_profile")
        out[f"{mode}_kernels_per_step"] = {n: c / k for n, c in prof["step_kernels"].items()}
        out[f"{mode}_device_ms_per_step"] = prof["device_ms"] / k
        if out[f"{mode}_kernels_per_step"] != want:
            raise AssertionError(f"B {b} {mode}: kernels a step {out[f'{mode}_kernels_per_step']} "
                                 f"!= {want}")
        # the profiled window's card time against the unprofiled host time
        out[f"{mode}_busy_share"] = out[f"{mode}_device_ms_per_step"] / out[f"{mode}_ms_per_step"]
    out["python_launches_per_replay"] = 0
    del model, graphed, multi
    fresh()
    if check_dropout:
        out["dropout"] = graph_dropout_check(batches)
    return out


def graph_dropout_check(batches) -> dict:
    """At dropout 0.1: a graphed window's losses equal the eager steps'
    from the same CUDA generator state, and two replays draw other K2
    seeds (each seed is copied out inside the capture)."""
    import torch

    from aladin_torch.ops.kernels import attention_kernel as ak
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_multi_train_step, make_train_step

    k = len(batches)
    cfg, model = flagship_train_model(True, 0.1)
    start = {n: v.detach().clone() for n, v in model.state_dict().items()}
    eager = TrainState(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, cfg, torch.bfloat16)
    torch.cuda.manual_seed(3)
    want = torch.stack([step(eager, x, 0)["loss"] for x in batches])
    del model, eager, step
    _, model = flagship_train_model(True, 0.1, start)
    graphed = TrainState(cfg, model, steps_per_epoch=100)
    multi = make_multi_train_step(model, cfg, torch.bfloat16, k=k)
    seen, launch = [], ak.attention_forward

    def recording(q, kk, v, bias, seed=0, *args):
        if torch.is_tensor(seed):
            seen.append(seed.clone())
        return launch(q, kk, v, bias, seed, *args)

    ak.attention_forward = recording
    try:
        torch.cuda.manual_seed(3)
        got = multi(graphed, batches, 0)["loss"]
    finally:
        ak.attention_forward = launch
    layers = model.oscar_model.bert.cfg.num_hidden_layers
    captured = seen[-k * 2 * layers:]  # the capture's: k steps x 2 passes x layers
    first = torch.stack(captured).cpu()
    multi(graphed, batches, 0)
    second = torch.stack(captured).cpu()
    if not torch.equal(got, want):
        raise AssertionError(f"dropout 0.1: graphed losses {got.tolist()} != eager {want.tolist()}")
    if torch.equal(first, second) or first.unique().numel() < first.numel() // 2:
        raise AssertionError("K2's seeds did not change across replays")
    return {"losses_equal_eager": True, "loss": got.tolist(),
            "seeds_per_replay": first.numel(), "seeds_changed_across_replays": True}


def phase_train_graph() -> dict:
    """--steps_per_dispatch's CUDA graph on the flagship step at VinVL-base
    width with both kernel knobs, at the recipe's bs 32 and at B 128."""
    import torch

    runs = {b: train_graph_at(b, check_dropout=b == 32) for b in (32, 128)}
    emit({"phase": "train_graph", "card": nvidia_smi_line(), "k": GRAPH_K,
          "runs": {str(b): r for b, r in runs.items()},
          "cuda": torch.version.cuda})
    return runs


def phase_train_cli() -> dict:
    """aladin_torch.cli.train end to end: one epoch, validation, checkpoint;
    then with both kernel knobs (an OSCAR directory whose config sets them),
    one epoch at K 1 and one at --steps_per_dispatch 8 with --profile_dir,
    whose checkpoint must load back, whose trace must name K2 and K3a, and
    whose steps, last metrics and best rsum must equal the K 1 run's (a
    window equals its single steps bit for bit at bs 32)."""
    import torch

    from aladin_torch.cli import train as cli_train
    from aladin_torch.data.dataset import make_synthetic_dataset
    from aladin_torch.io.checkpoint import load_checkpoint

    def run(argv):
        """(cli/train's result, seconds, K1 launches); the checkpoint must
        load back equal and the metrics be finite."""
        before = launch_counts(K1_COUNTER)
        t0 = time.perf_counter()
        out = cli_train.run(argv)
        run_s = time.perf_counter() - t0
        launches = launches_since(before, K1_COUNTER)["k1"]
        trainer, state = out["trainer"], out["state"]
        if launches == 0:
            raise AssertionError("cli/train's validation never launched the MrSw kernel")
        metrics = trainer.last_metrics
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cli/train metrics not finite: {metrics}")
        payload, _ = load_checkpoint(out["checkpoint"])
        sd = state.model.state_dict()
        if (payload["step"] != state.step or set(payload["model"]) != set(sd)
                or not all(torch.equal(payload["model"][k], v.cpu()) for k, v in sd.items())):
            raise AssertionError("the checkpoint cli/train wrote does not load back equal")
        return out, run_s, launches

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        oscar, data = os.path.join(tmp, "oscar"), os.path.join(tmp, "coco_ir")
        write_oscar_dir(oscar, SYNTH_VOCAB)
        make_synthetic_dataset(data, n_images=200, feat_dim=2054)
        setup_s = time.perf_counter() - t0
        argv = ["--config", os.path.join(ROOT, "aladin_torch", "configs", RECIPE),
                "--eval_model_dir", oscar, "--data_dir", data,
                "--img_feat_file", os.path.join(data, "features.tsv"), "--max_seq_length", "50",
                "--max_img_seq_length", "34", "--add_od_labels", "--output_dir", tmp,
                "--logger_name", os.path.join(tmp, "run"), "--num_epochs", "1",
                "--val_step", "0", "--log_step", "10", "--device", "cuda"]
        # the first run also scores NDCG over synthetic minival relevances
        write_relevances(os.path.join(data, "relevances"), "minival", 5 * 200, 200)
        out, run_s, launches = run(argv + ["--ndcg"])
        trainer, state = out["trainer"], out["state"]
        best_ndcg = os.path.join(tmp, "run", "model_best_ndcgspice.pth.tar")
        if not (trainer.best_ndcgspice > 0 and os.path.exists(best_ndcg)):
            raise AssertionError(f"cli/train --ndcg: best spice NDCG {trainer.best_ndcgspice}, "
                                 f"{best_ndcg} written: {os.path.exists(best_ndcg)}")
        emit({"phase": "train_cli", "images": 200, "bs": 32, "steps": state.step,
              "setup_seconds": setup_s, "run_seconds": run_s, "k1_launches": launches,
              "best_rsum": trainer.best_rsum, "best_ndcgspice": trainer.best_ndcgspice,
              "model_best_ndcgspice_written": True, "metrics_last": trainer.last_metrics,
              "checkpoint_loads_back": True})

        fused = os.path.join(tmp, "oscar_fused")
        write_oscar_dir(fused, SYNTH_VOCAB, fused_attention=True, fused_layernorm=True)
        argv[argv.index(oscar)] = fused
        windowed = {}
        for k in (1, GRAPH_K):
            extra = ["--logger_name", os.path.join(tmp, f"run_fused_k{k}"),
                     "--steps_per_dispatch", str(k)]
            if k > 1:
                extra += ["--profile_dir", os.path.join(tmp, "trace")]
            out, run_s, launches = run(argv + extra)
            windowed[k] = {"steps": out["state"].step, "run_seconds": run_s,
                           "k1_launches": launches, "best_rsum": out["trainer"].best_rsum,
                           "metrics_last": out["trainer"].last_metrics}
        same = {key: windowed[1][key] == windowed[GRAPH_K][key]
                for key in ("steps", "best_rsum", "metrics_last")}
        if not all(same.values()):
            raise AssertionError(f"cli/train at K {GRAPH_K} differs from K 1 in "
                                 f"{[key for key, v in same.items() if not v]}: {windowed}")
        with open(os.path.join(tmp, "trace", "trace.json")) as f:
            kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        names = set(kernels)
        traced = {k: sum(pat in n for n in names) for k, pat in STEP_KERNELS.items()}
        if not all(traced.values()):
            raise AssertionError(f"the --profile_dir trace misses step kernels: {traced}")
        pad_kept = sum(PAD_KERNEL in n for n in kernels)  # utils/profiling.py::Trace's pad
        if not pad_kept:
            raise AssertionError(f"the --profile_dir trace kept none of its {PROFILE_PAD} pad "
                                 f"kernels")
    emit({"phase": "train_cli_windowed", "images": 200, "bs": 32, "knobs": "K2 + K3a",
          "card": nvidia_smi_line(), "runs": {f"k{k}": v for k, v in windowed.items()},
          "trace_kernel_names": traced, "trace_pad_kept": pad_kept,
          "checkpoint_loads_back": True, "k8_equals_k1": True})
    return {"launches": launches}

# encoder micro-batch losses against the unsplit step's at dropout 0: the
# same math with the GEMMs at another M (other cuBLAS tiles, other bf16
# sums), which moves a loss of O(10) by far less than 1e-3 of itself
MICROBATCH_LOSS_RTOL = 1e-3
LEVER_MB = 128  # encoder-microbatch of the B 512 runs
LEVER_CHUNK = 8  # alignment-chunk of the bs 32 run: four blocks of captions


def counted(fn):
    """(fn's result, the step kernels' launches while it ran)."""
    import torch

    before = launch_counts(STEP_COUNTERS)
    out = fn()
    torch.cuda.synchronize()
    return out, launches_since(before, STEP_COUNTERS)


def step_launches(layers: int, remat: bool, micro: int = 0, passes: int = 2) -> dict:
    """The K2 / K3a launches of one step over ``micro`` encoder
    micro-batches (0: unsplit): a backward a layer call, and a forward a
    layer call and run of it: once, twice under remat or micro-batches (the
    recompute), three times under both (the micro-batch's recompute runs
    the remat layers, which the backward runs again); two LayerNorms a
    layer."""
    runs = (3 if remat else 2) if micro else (2 if remat else 1)
    calls = max(micro, 1) * passes * layers
    return {"k2_fwd": calls * runs, "k2_bwd": calls, "k3a": 2 * calls * runs,
            "k3a_bwd": 2 * calls}


def fresh_memory() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def lever_step(start, b: int, dropout: float, remat: bool, mb: int = 0, chunk: int = 0):
    """(model, state, step fn) of the flagship recipe at batch ``b`` with
    the kernel knobs, from the weights ``start``."""
    import torch

    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_train_step

    cfg, model = flagship_train_model(True, dropout, start, remat=remat,
                                      training_over={"bs": b, "encoder-microbatch": mb,
                                                     "alignment-chunk": chunk})
    state = TrainState(cfg, model, steps_per_epoch=100)
    return model, state, make_train_step(model, cfg, torch.bfloat16)


def phase_train_levers() -> dict:
    """The memory levers at VinVL-base width with K2 and K3a: (a) remat
    equals no remat bit for bit at bs 32, dropout 0.1, and doubles the
    forward launches; the alignment head in chunks of LEVER_CHUNK captions
    (``alignment-chunk``) gives the unchunked loss within
    MICROBATCH_LOSS_RTOL and the same launches; (b) B 512 at dropout 0 with no lever, remat,
    encoder-microbatch 128 and both: peak memory, host and card ms a step,
    launches, the first step's loss against the no-lever one (remat bit for
    bit, micro-batches within MICROBATCH_LOSS_RTOL), remat's peak below the
    no-lever peak; (c) a CUDA graph of 8 remat steps (and of remat with
    micro-batches of 16) against 8 eager steps at bs 32, bit for bit."""
    import torch

    from aladin_torch.train.step import make_multi_train_step

    _, model = flagship_train_model(True, 0.0)
    start = {n: v.detach().clone() for n, v in model.state_dict().items()}
    layers = model.oscar_model.bert.cfg.num_hidden_layers
    del model
    out = {"card": nvidia_smi_line()}

    # (a) bs 32, dropout 0.1: remat, and the alignment head in chunks of
    # LEVER_CHUNK captions, against neither, one eager step each
    batch = synth_train_batch(32)
    runs = {}
    for name, remat, chunk in (("none", False, 0), ("remat", True, 0),
                               ("chunk", False, LEVER_CHUNK)):
        fresh_memory()
        model, state, step = lever_step(start, 32, 0.1, remat, chunk=chunk)
        torch.cuda.manual_seed(7)
        metrics, launches = counted(lambda: step(state, batch, 0))
        runs[name] = (metrics, [p.detach().clone() for p in state.trainable], launches)
        del model, state, step
    (m0, p0, n0), (m1, p1, n1), (mc, _, nc) = runs["none"], runs["remat"], runs["chunk"]
    diff = [k for k in m0 if not torch.equal(m0[k], m1[k])]
    if diff or not all(torch.equal(a, c) for a, c in zip(p0, p1)):
        raise AssertionError(f"bs 32, dropout 0.1: remat differs from no remat in metrics "
                             f"{diff} or the post-step parameters")
    if n0 != step_launches(layers, False) or n1 != step_launches(layers, True):
        raise AssertionError(f"launches a step without / with remat {n0} / {n1}, expected "
                             f"{step_launches(layers, False)} / {step_launches(layers, True)}")
    # the chunked head scores the same pairs block by block (other GEMM shapes)
    chunk_rel = abs(mc["loss"].item() - m0["loss"].item()) / abs(m0["loss"].item())
    if not chunk_rel <= MICROBATCH_LOSS_RTOL or nc != n0:
        raise AssertionError(f"bs 32, dropout 0.1, alignment-chunk {LEVER_CHUNK}: loss "
                             f"{mc['loss'].item()} against {m0['loss'].item()} (rel {chunk_rel}, "
                             f"limit {MICROBATCH_LOSS_RTOL}), launches {nc} against {n0}")
    out["bs32_dropout0.1"] = {"remat_equals_no_remat_bitwise": True, "loss": m0["loss"].item(),
                              "launches_no_remat": n0, "launches_remat": n1,
                              "alignment_chunk": LEVER_CHUNK,
                              "chunk_loss_rel_diff_vs_none": chunk_rel}
    del runs, p0, p1

    # (b) B 512, dropout 0: the four settings from one state and batch
    batch = synth_train_batch(512)
    settings = {"none": (False, 0), "remat": (True, 0), "microbatch128": (False, LEVER_MB),
                "both": (True, LEVER_MB)}
    b512, losses = {}, {}
    for name, (remat, mb) in settings.items():
        fresh_memory()
        model, state, step = lever_step(start, 512, 0.0, remat, mb)
        metrics, launches = counted(lambda: step(state, batch, 0))
        losses[name] = metrics["loss"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, batch, 0)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / 2
        prof = device_profile(lambda: step(state, batch, 0), 1, top=0)
        b512[name] = {"peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "host_ms_per_step": host_ms, "card_ms_per_step": prof["device_ms"],
                      "launches": launches, "first_loss": metrics["loss"].item()}
        if not all(math.isfinite(v.item()) for v in metrics.values()):
            raise AssertionError(f"B 512 {name}: non-finite metrics {metrics}")
        want = step_launches(layers, remat, 512 // mb if mb else 0)
        if launches != want:
            raise AssertionError(f"B 512 {name}: launches {launches}, expected {want}")
        del model, state, step
    if not torch.equal(losses["remat"], losses["none"]):
        raise AssertionError(f"B 512: remat's loss {losses['remat'].item()} != the no-lever "
                             f"loss {losses['none'].item()}")
    for name in ("microbatch128", "both"):
        rel = abs(losses[name].item() - losses["none"].item()) / abs(losses["none"].item())
        b512[name]["loss_rel_diff_vs_none"] = rel
        if not rel <= MICROBATCH_LOSS_RTOL:
            raise AssertionError(f"B 512 {name}: loss {losses[name].item()} against "
                                 f"{losses['none'].item()} (rel {rel} > {MICROBATCH_LOSS_RTOL})")
    if not b512["remat"]["peak_mem_gb"] < b512["none"]["peak_mem_gb"]:
        raise AssertionError(f"B 512: remat's peak {b512['remat']['peak_mem_gb']} GB is not "
                             f"below the no-lever peak {b512['none']['peak_mem_gb']} GB")
    out["b512_dropout0"] = b512
    del batch

    # (c) the levers inside a CUDA graph of 8 steps, bs 32, dropout 0
    batches = [synth_train_batch(32, seed=10 + i) for i in range(GRAPH_K)]
    windows = {}
    for name, mb in (("remat", 0), ("remat_microbatch16", 16)):
        fresh_memory()
        model, state, step = lever_step(start, 32, 0.0, True, mb)
        torch.cuda.manual_seed(1)
        eager = [step(state, x, 0) for x in batches]
        want_m = {n: torch.stack([r[n] for r in eager]) for n in eager[0]}
        want_p = [p.detach().clone() for p in state.trainable]
        del model, state, step, eager
        fresh_memory()
        model, state, _ = lever_step(start, 32, 0.0, True, mb)
        multi = make_multi_train_step(model, state.cfg, torch.bfloat16, k=GRAPH_K)
        torch.cuda.manual_seed(1)
        t0 = time.perf_counter()
        got = multi(state, batches, 0)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        if multi.window is None:
            raise AssertionError(f"{name}: no CUDA graph was captured")
        diff = [n for n in want_m if not torch.equal(want_m[n], got[n])]
        if diff or not all(torch.equal(a, c) for a, c in zip(want_p, state.trainable)):
            raise AssertionError(f"{name}: the graphed window of {GRAPH_K} differs from "
                                 f"{GRAPH_K} eager steps (metrics {diff} or parameters)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(state, batches, 0)
        torch.cuda.synchronize()
        windows[name] = {"graph_equals_eager_bitwise": True, "capture_and_first_replay_s":
                         capture_s, "graph_ms_per_step": 1e3 * (time.perf_counter() - t0)
                         / GRAPH_K, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        del model, state, multi
    out["graph_k8_bs32"] = windows
    fresh_memory()
    emit({"phase": "train_levers", **out, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return {"remat_launches": n1}


# the model variants at VinVL-base width: (name, model recipe keys)
VARIANTS = (
    ("align_gated_fusion", {"depth-aggregation-alignment": "gated"}),
    ("match_transformer_post1", {"depth-aggregation-matching": "transformer",
                                 "post-layers": 1}),
    ("match_mean", {"depth-aggregation-matching": "mean"}),
    ("teran2_shared", {"teran-layers": 2}),
    ("teran2_separate_frozen", {"teran-layers": 2, "shared-transformer": False,
                                "freeze-teran": True}),
)


def phase_variants() -> dict:
    """Each model variant at VinVL-base width, bs 32, from weights of a
    seed: one step with the kernel knobs on against the same weights with
    them off, every dropout at 0 (the variant modules' own fixed rates
    too), loss and grad_norm within KNOB_LOSS_RTOL / KNOB_GNORM_RTOL; then
    three steps with the modules' fixed rates back (the recipe's dropout
    0), finite, the first with exactly 24 / 24 / 48 / 48 K2 / K3a launches;
    host ms a step and peak memory."""
    import torch
    from torch import nn

    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_train_step

    batch = synth_train_batch(32)
    out = {}
    for name, over in VARIANTS:
        fresh_memory()
        first = {}
        for fused in (True, False):
            cfg, model = flagship_train_model(fused, 0.0, first.get("start"), model_over=over)
            if fused:
                first["start"] = {n: v.detach().clone() for n, v in model.state_dict().items()}
            rates = {m: m.p for m in model.modules() if isinstance(m, nn.Dropout)}
            for m in rates:
                m.p = 0.0
            state = TrainState(cfg, model, steps_per_epoch=100)
            step = make_train_step(model, cfg, torch.bfloat16)
            first[fused] = {k: v.item() for k, v in step(state, batch, 0).items()}
            if fused:
                for m, p in rates.items():
                    m.p = p
                kept = (model, state, step)
            del model, state, step
        on, off = first[True], first[False]
        agree = {"loss_rel_diff": abs(on["loss"] - off["loss"]) / abs(off["loss"]),
                 "grad_norm_rel_diff": abs(on["grad_norm"] - off["grad_norm"])
                 / abs(off["grad_norm"])}
        if not (agree["loss_rel_diff"] <= KNOB_LOSS_RTOL
                and agree["grad_norm_rel_diff"] <= KNOB_GNORM_RTOL):
            raise AssertionError(f"variant {name}: knobs on vs off disagree: {first} {agree}")
        model, state, step = kept
        del kept
        layers = model.oscar_model.bert.cfg.num_hidden_layers
        metrics, launches = counted(lambda: step(state, batch, 0))
        rows = [metrics]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows += [step(state, batch, 0) for _ in range(2)]
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / 2
        rows = [{k: v.item() for k, v in r.items()} for r in rows]
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"variant {name}: non-finite metrics {rows}")
        if launches != step_launches(layers, False):
            raise AssertionError(f"variant {name}: launches {launches}, expected "
                                 f"{step_launches(layers, False)}")
        out[name] = {"model": over, "knob_check_dropout0": {**agree, "on": on, "off": off},
                     "launches": launches, "host_ms_per_step": host_ms,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "metrics_last": rows[-1]}
        del model, state, step, first
    fresh_memory()
    emit({"phase": "variants", "batch": 32, "card": nvidia_smi_line(), "runs": out,
          "loss_rtol": KNOB_LOSS_RTOL, "grad_norm_rtol": KNOB_GNORM_RTOL})
    return out


# the words of the synthetic pretraining and task corpora; with SYNTH_VOCAB
# and fillers they make a vocab of BERT-base size
TASK_WORDS = ["in", "coco", "flickr30k", "what", "is", "picture", "object", "appears", "here",
              "left", "image", "contains", "yes", "no"]
BERT_BASE_VOCAB = 30522
PRETRAIN_LR = 5e-5
PRETRAIN_ITERS, PRETRAIN_WARMUP, PRETRAIN_CKPT = 20, 4, 10


def write_vocab_dir(path: str) -> None:
    """A model directory holding a vocab.txt of 30522 entries (what
    BertWordPieceTokenizer.from_pretrained reads): the synthetic corpora's
    tokens, then fillers."""
    words = list(SYNTH_VOCAB) + TASK_WORDS
    words += [f"[unused{i}]" for i in range(BERT_BASE_VOCAB - len(words))]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")


def step_times(step, batch, n: int = 5) -> dict:
    """Host ms a step (after one warm-up step, each closed by a synchronize),
    and the profiler's card ms and busy share of the same step."""
    import torch

    step(*batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(*batch)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / n
    prof = device_profile(lambda: step(*batch), 3, top=6)
    return {"host_ms_per_step": host_ms, "card_ms_per_step": prof["device_ms"],
            "device_busy_share": prof["device_ms"] / host_ms, "top": prof["top"]}


def knob_check(what: str, build, batch, start, lr: float) -> dict:
    """One bf16 step at dropout 0 from the weights ``start`` with the kernel
    knobs on (``build(True, 0.0)``) and off: the loss and grad_norm within
    KNOB_LOSS_RTOL / KNOB_GNORM_RTOL, every gradient within KNOB_GNORM_RTOL
    (relative L2), every parameter within what one AdamW step at ``lr``
    allows; raises beyond them. Returns {"agreement", "on_times",
    "off_times"} (step_times of each)."""
    import torch

    from aladin_torch.train.schedule import global_norm

    first, moved, grads, times = {}, {}, {}, {}
    for fused in (True, False):
        m, step = build(fused, 0.0)
        first[fused] = {k: v.item() for k, v in step(*batch).items()}
        # a parameter the loss does not reach (a captioner's pooler) has no gradient
        grads[fused] = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                        for p in m.parameters()]
        first[fused]["grad_norm"] = global_norm(grads[fused]).item()
        moved[fused] = {k: v.detach().clone() for k, v in m.named_parameters()}
        times[fused] = step_times(step, batch)
        del m, step
    on, off = first[True], first[False]
    agree = {"loss_rel_diff": abs(on["loss"] - off["loss"]) / abs(off["loss"]),
             "grad_norm_rel_diff": abs(on["grad_norm"] - off["grad_norm"]) / off["grad_norm"],
             # every parameter's gradient: |g_on - g_off| / |g_off| over all of them
             "grad_rel_l2_diff": global_norm([a - b for a, b in zip(grads[True], grads[False])]
                                             ).item() / off["grad_norm"],
             # one AdamW step from one state moves a parameter by at most
             # lr (1 + weight decay * |p|) on either side
             "param_max_abs_diff": max(float((moved[True][k] - moved[False][k]).abs().max())
                                       for k in moved[True])}
    param_bound = 2 * lr * (1 + 0.01 * max(float(v.abs().max()) for v in start.values())) * 1.001
    if not (agree["loss_rel_diff"] <= KNOB_LOSS_RTOL
            and agree["grad_norm_rel_diff"] <= KNOB_GNORM_RTOL
            and agree["grad_rel_l2_diff"] <= KNOB_GNORM_RTOL
            and agree["param_max_abs_diff"] <= param_bound):
        raise AssertionError(f"{what}: knobs on vs off disagree: {first} {agree}")
    return {"agreement": {"on": on, "off": off, **agree, "param_bound": param_bound,
                          "loss_rtol": KNOB_LOSS_RTOL, "grad_norm_rtol": KNOB_GNORM_RTOL},
            "on_times": times[True], "off_times": times[False]}


def phase_pretrain(tmp: str, vocab_dir: str) -> dict:
    """OSCAR+ pretraining at VinVL-base width: (a) cli/pretrain over a
    synthetic corpus (knobs off, f32, as aladin_tpu's CLI), its losses, lr
    and checkpoints; (b) one step from one state at dropout 0 with K2 and
    K3a on against off (bf16 autocast), and the launches of a step at
    dropout 0.1."""
    import torch

    from aladin_torch.cli import pretrain as pretrain_cli
    from aladin_torch.tasks.pretrain_data import make_synthetic_pretrain_corpus
    from aladin_torch.tasks.pretraining import BertImgForPreTraining, make_pretrain_step
    from aladin_torch.train.schedule import warmup_linear_schedule

    root, run_dir = os.path.join(tmp, "pretrain_corpus"), os.path.join(tmp, "pretrain_run")
    make_synthetic_pretrain_corpus(root, ("coco", "flickr30k"), n_images_per_dataset=64,
                                   feat_dim=2054)
    fresh_memory()
    t0 = time.perf_counter()
    (res, cli_launches) = counted(lambda: pretrain_cli.run([
        "--pretrain_root", root, "--eval_model_dir", vocab_dir, "--output_dir", run_dir,
        "--train_batch_size", "32", "--max_iters", str(PRETRAIN_ITERS),
        "--warmup_steps", str(PRETRAIN_WARMUP), "--ckpt_period", str(PRETRAIN_CKPT),
        "--log_step", "5", "--device", "cuda"]))
    cli_seconds = time.perf_counter() - t0
    cfg = res["model"].bert.cfg
    if (cfg.num_hidden_layers, cfg.hidden_size, cfg.img_feature_dim, cfg.vocab_size) != (
            12, 768, 2054, BERT_BASE_VOCAB):
        raise AssertionError(f"pretrain: not VinVL-base width: {cfg}")
    steps = [m for r in res["log"] for m in r["steps"]]
    if len(steps) != PRETRAIN_ITERS or not all(math.isfinite(v) for m in steps
                                                for v in m.values()):
        raise AssertionError(f"pretrain: {len(steps)} steps, losses {steps}")
    sched = warmup_linear_schedule(PRETRAIN_LR, PRETRAIN_WARMUP, PRETRAIN_ITERS)
    lrs = [(r["iter"], r["lr"]) for r in res["log"]]
    if any(lr != sched(it - 1) for it, lr in lrs):
        raise AssertionError(f"pretrain: logged lr {lrs} off the schedule")
    names = [os.path.basename(p) for p in res["checkpoints"]]
    if names != ["ckpt_0000010.pth.tar", "ckpt_0000020.pth.tar"]:
        raise AssertionError(f"pretrain: checkpoints {names}")
    for path in res["checkpoints"]:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        keys = BertImgForPreTraining(cfg).load_state_dict(ckpt["model"], strict=True)
        if keys.missing_keys or keys.unexpected_keys:
            raise AssertionError(f"pretrain: {path}: {keys}")
    peak_cli = torch.cuda.max_memory_allocated() / 2 ** 30
    # the CLI's own ms/it: collation on the host included
    cli_log = [{k: v for k, v in r.items() if k != "steps"} for r in res["log"]]
    cli_times = step_times(res["step"], res["batch"])
    start = {k: v.detach().clone() for k, v in res["model"].state_dict().items()}
    batch = res["batch"]
    del res
    fresh_memory()

    def build(fused: bool, dropout: float):
        """(model, step fn) from ``start``: AdamW at lr 5e-5 with no
        warmup, bf16 autocast, both kernel knobs set to ``fused``."""
        c = dataclasses.replace(cfg, fused_attention=fused, fused_layernorm=fused,
                                hidden_dropout_prob=dropout,
                                attention_probs_dropout_prob=dropout)
        m = BertImgForPreTraining(c)
        m.load_state_dict(start)
        m.to(batch[0].device)
        opt, _ = pretrain_cli.make_optimizer(m, PRETRAIN_LR, 0, PRETRAIN_ITERS)
        return m, make_pretrain_step(m, opt, torch.bfloat16)

    knobs = knob_check("pretrain", build, batch, start, PRETRAIN_LR)
    fresh_memory()
    m, step = build(True, 0.1)
    metrics, launches = counted(lambda: step(*batch))
    want = step_launches(cfg.num_hidden_layers, False, passes=1)
    if launches != want or not all(math.isfinite(v.item()) for v in metrics.values()):
        raise AssertionError(f"pretrain: launches {launches}, expected {want}; {metrics}")
    emit({"phase": "pretrain", "card": nvidia_smi_line(), "batch": 32,
          "seq": "35 text + 50 regions", "iters": PRETRAIN_ITERS, "cli_seconds": cli_seconds,
          "cli_log": cli_log, "losses_first_last": [steps[0], steps[-1]], "lr": lrs,
          "checkpoints": names, "cli_kernel_launches": cli_launches,
          "f32_knobs_off": {**cli_times, "peak_mem_gb": peak_cli},
          "knob_check_dropout0": knobs["agreement"],
          "bf16_knobs_on": knobs["on_times"], "bf16_knobs_off": knobs["off_times"],
          "launches_dropout0.1": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    del m, step
    fresh_memory()
    return {"launches": launches}


def phase_classify(tmp: str, vocab_dir: str) -> dict:
    """cli/classify --task vqa and --task nlvr at VinVL-base width over
    make_synthetic_task_data (2054-d regions, 128 examples a split), bs 32,
    one epoch, --do_test: finite losses, a validation score in [0, 1], one
    prediction a test example; host and card ms a step, peak memory."""
    import torch

    from aladin_torch.cli import classify as classify_cli
    from aladin_torch.tasks.task_inputs import make_synthetic_task_data

    data = os.path.join(tmp, "task_data")
    make_synthetic_task_data(data, n_images=64, feat_dim=2054, n_examples=128)
    out = {}
    for task in ("vqa", "nlvr"):
        fresh_memory()
        t0 = time.perf_counter()
        res = classify_cli.run(["--task", task, "--data_dir", data, "--eval_model_dir",
                                vocab_dir, "--output_dir", os.path.join(tmp, f"classify_{task}"),
                                "--train_batch_size", "32", "--epochs", "1", "--do_test",
                                "--log_step", "1", "--device", "cuda"])
        seconds = time.perf_counter() - t0
        with open(res["test_results"]) as f:
            n_pred = len(json.load(f))
        ok = (len(res["losses"]) == 4 and all(math.isfinite(v) for v in res["losses"])
              and all(0.0 <= s <= 1.0 for s in res["val_scores"]) and n_pred == 128)
        if not ok:
            raise AssertionError(f"classify {task}: losses {res['losses']}, val "
                                 f"{res['val_scores']}, {n_pred} predictions")
        streams = 2 * 32 if task == "nlvr" else 32
        out[task] = {"seconds": seconds, "losses": res["losses"], "val_score": res["val_scores"],
                     "test_predictions": n_pred, "streams_a_batch": streams,
                     "seq": "128 text + 50 regions",
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                     **step_times(res["step"], res["batch"])}
        del res
    fresh_memory()
    emit({"phase": "classify", "card": nvidia_smi_line(), "batch": 32, "runs": out})
    return out


# captioning at the COCO geometry of benchmarks/caption_decode_bench.py: 40
# caption slots, 30 OD-label tokens, 50 regions (L 120), the CLI's defaults
CAPTION_LR = 3e-5  # cli/captioning's default
CAPTION_CLI_IMAGES, CAPTION_CLI_EPOCHS = 8, 4  # 40 pairs: one step of 32 an epoch
DECODE_IMAGES, DECODE_STEPS, DECODE_BEAMS = 16, 39, 5
# the decode checks' captioner: trained on the card until its decisions are
# far apart. argmax over logits within rounding of each other is decided by
# the rounding, and two right implementations (cached against full
# recompute, K2 against plain attention) may then emit other tokens, after
# which the rows diverge; a trained captioner's top two are far apart, and
# the smallest top-1 margin of every decision is printed beside the check
DECODE_CAPTION = "a photo of the dog in the house left of a tree in the picture of the image"
DECODE_TRAIN_LR, DECODE_TRAIN_EPOCHS = 2e-4, 30  # 80 pairs: 2 steps an epoch
# f32 summed log-probs, cached against full recompute: the same f32 math
# summed in other orders (other GEMM shapes), ~1e-6 relative a value
DECODE_F32_RTOL = 1e-4
# bf16 summed log-probs, K2 against plain attention: their attention
# outputs are one bf16 rounding (2^-8 relative) apart in places, carried
# through 12 layers to the log-probs of the ~20 real tokens of a caption;
# 0.1 is 20 tokens at 2^-8 of a log-prob of O(1)
DECODE_BF16_ATOL = 0.1


def caption_corpus(root: str, n_images: int, caption: str = "") -> None:
    """The synthetic caption corpus (make_synthetic_dataset) with 2054-d
    features and up to 50 boxes an image, so that the OD labels fill their
    30 slots; ``caption``: every training caption replaced by it."""
    from aladin_torch.data.dataset import make_synthetic_dataset

    make_synthetic_dataset(root, n_images=n_images, feat_dim=2054, max_boxes=50)
    if caption:
        path = os.path.join(root, "train_captions.json")
        with open(path) as f:
            keys = list(json.load(f))
        with open(path, "w") as f:
            json.dump({k: [caption] * 5 for k in keys}, f)


def check_width(what: str, cfg) -> None:
    if (cfg.num_hidden_layers, cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            cfg.img_feature_dim, cfg.vocab_size) != (12, 768, 12, 3072, 2054, BERT_BASE_VOCAB):
        raise AssertionError(f"{what}: not VinVL-base width: {cfg}")


def timed_decode(fn, steps: int) -> dict:
    """Host ms of one decode (the host clock to a synchronize) and the
    profiler's card ms of another, a batch and a step."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host = 1e3 * (time.perf_counter() - t0)
    card = device_profile(fn, 1, top=4)
    return {"host_ms_batch": host, "card_ms_batch": card["device_ms"],
            "host_ms_step": host / steps, "card_ms_step": card["device_ms"] / steps,
            "card_busy_share": card["device_ms"] / host, "top": card["top"]}


def decision_margins(model, toks, inp, common) -> float:
    """The smallest top-1 log-prob margin over the decisions that made the
    greedy rows ``toks`` (rows that ended before a step excluded),
    evaluated with the prefix of each step as the decoder saw it."""
    import torch
    import torch.nn.functional as F

    from aladin_torch.tasks.captioning import StepInputs

    s = toks.shape[1]
    step_inp = StepInputs(model, *inp, s)
    pos = torch.arange(s, device=toks.device)[None]
    alive = torch.ones(toks.shape[0], dtype=torch.bool, device=toks.device)
    least = float("inf")
    with torch.no_grad():
        for t in range(1, s):
            cap = torch.where(pos < t, toks, common["mask_id"])
            top2 = F.log_softmax(step_inp.logits(cap, t), -1).topk(2).values
            if alive.any():
                least = min(least, float((top2[:, 0] - top2[:, 1])[alive].min()))
            alive &= toks[:, t] != common["sep_id"]
    return least


def phase_caption(tmp: str, vocab_dir: str) -> dict:
    """Captioning at VinVL-base width and the COCO geometry: (a)
    cli/captioning (f32, knobs off) over a synthetic corpus of 8 images,
    4 steps of 32, decoding with greedy + one SCST epoch, beam 5, --kv_cache
    and --use_cbs; (b) one bf16 step at dropout 0 with K2 (2-D masks,
    bias_q == S) + K3a on against off, and the launches of a step; (c) on a
    captioner trained here, decoding 16 images in f32 with full recompute
    and with the KV cache, greedy and beam 5: equal tokens; (d) bf16 full-
    recompute greedy with fused_attention against without: equal tokens,
    12 x 39 K2 forwards."""
    import torch

    from aladin_torch.cli import captioning as cap_cli
    from aladin_torch.cli import pretrain as pretrain_cli
    from aladin_torch.data.tokenizer import BertWordPieceTokenizer
    from aladin_torch.tasks import captioning as cap
    from aladin_torch.tasks import decode_cache as dc
    from aladin_torch.tasks.task_inputs import ImageFeatureProvider

    out = {"card": nvidia_smi_line(), "geometry": "40 caption + 30 OD labels + 50 regions"}
    part_s, t_part = {}, time.perf_counter()

    # (a) the CLI end to end, one run a decoding mode
    root = os.path.join(tmp, "caption_corpus")
    caption_corpus(root, CAPTION_CLI_IMAGES)

    def cli(run_root, run_dir, *extra):
        return cap_cli.run(["--data_dir", run_root, "--eval_model_dir", vocab_dir,
                            "--output_dir", os.path.join(tmp, run_dir), "--train_batch_size",
                            "32", "--eval_batch_size", "8", "--device", "cuda", *extra])

    runs, greedy_res = {}, None
    for mode, extra in (("greedy_scst", ["--scst_epochs", "1"]),
                        ("beam5", ["--num_beams", str(DECODE_BEAMS)]),
                        ("kv_cache", ["--kv_cache"]), ("cbs", ["--use_cbs"])):
        fresh_memory()
        t0 = time.perf_counter()
        res = cli(root, f"caption_{mode}", "--epochs", str(CAPTION_CLI_EPOCHS), *extra)
        seconds = time.perf_counter() - t0
        check_width(f"caption {mode}", res["model"].bert.cfg)
        losses = [v for e in res["losses"] for v in e]
        preds = res["predictions"]
        ok = (len(losses) == CAPTION_CLI_EPOCHS and all(math.isfinite(v) for v in losses)
              and len(preds) == CAPTION_CLI_IMAGES
              and all(math.isfinite(res["metrics"][k]) for k in ("Bleu_1", "ROUGE_L", "CIDEr")))
        if mode == "greedy_scst":
            ok = ok and len(res["scst_losses"]) == 1 and all(
                math.isfinite(v) for v in res["scst_losses"][0])
        if mode == "cbs":  # every caption holds one of its image's detected class words
            prov = ImageFeatureProvider(os.path.join(root, "features.tsv"))
            hits = sum(bool({o["class"] for o in prov.get_objects(k)} & set(p[0].split()))
                       for k, p in preds.items())
            ok = ok and hits == len(preds)
        if not ok:
            raise AssertionError(f"caption {mode}: losses {losses} scst {res['scst_losses']} "
                                 f"metrics {res['metrics']} predictions {preds}")
        runs[mode] = {"seconds": seconds, "losses": losses, "scst_losses": res["scst_losses"],
                      "metrics": {k: v for k, v in res["metrics"].items()},
                      "caption_0": next(iter(preds.values()))[0],
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        if mode == "greedy_scst":
            greedy_res = res
        else:
            del res
    out["cli"] = runs
    fresh_memory()
    out["f32_knobs_off"] = step_times(greedy_res["step"], greedy_res["batch"])
    out["f32_knobs_off"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    part_s["a_cli"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (b) K2 (bias_q == S) + K3a on against off, one state, dropout 0
    cfg = greedy_res["model"].bert.cfg
    start = {k: v.detach().clone() for k, v in greedy_res["model"].state_dict().items()}
    batch = greedy_res["batch"]
    del greedy_res
    fresh_memory()

    def build(fused: bool, dropout: float):
        c = dataclasses.replace(cfg, fused_attention=fused, fused_layernorm=fused,
                                hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
        m = cap.BertImageCaptioner(c)
        m.load_state_dict(start)
        m.cuda()
        opt, _ = pretrain_cli.make_optimizer(m, CAPTION_LR, 0, 10)
        return m, cap.make_caption_train_step(m, opt, 0.1, compute_dtype=torch.bfloat16)

    knobs = knob_check("caption", build, batch, start, CAPTION_LR)
    out["knob_check_dropout0"] = knobs["agreement"]
    out["bf16_knobs_on"], out["bf16_knobs_off"] = knobs["on_times"], knobs["off_times"]
    fresh_memory()
    m, step = build(True, 0.1)
    metrics, launches = counted(lambda: step(*batch))
    want = step_launches(cfg.num_hidden_layers, False, passes=1)
    if launches != want or not math.isfinite(metrics["loss"].item()):
        raise AssertionError(f"caption: step launches {launches}, expected {want}; {metrics}")
    out["launches_step_dropout0.1"] = launches
    del m, step, start
    fresh_memory()
    part_s["b_step"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (c) decoding 16 images with a captioner trained here: full recompute
    # against the KV cache, f32
    droot = os.path.join(tmp, "decode_corpus")
    caption_corpus(droot, DECODE_IMAGES, DECODE_CAPTION)
    t0 = time.perf_counter()
    res = cli(droot, "decode_train", "--epochs", str(DECODE_TRAIN_EPOCHS), "--learning_rate",
              str(DECODE_TRAIN_LR))
    out["decode_model"] = {"caption": DECODE_CAPTION, "steps": sum(len(e) for e in res["losses"]),
                           "lr": DECODE_TRAIN_LR, "seconds": time.perf_counter() - t0,
                           "loss_first_last": [res["losses"][0][0], res["losses"][-1][-1]],
                           "metrics": res["metrics"]}
    model = res["model"].eval()
    del res
    part_s["c_train"], t_part = time.perf_counter() - t_part, time.perf_counter()
    tok = BertWordPieceTokenizer.from_pretrained(vocab_dir)
    tz = cap.CaptionTensorizer(tok)
    prov = ImageFeatureProvider(os.path.join(droot, "features.tsv"))
    keys = sorted(prov.id2idx)[:DECODE_IMAGES]
    inp = [torch.from_numpy(a).cuda() for a in cap_cli.decode_inputs(
        tok, tz, [prov.get_od_labels(k) for k in keys], [prov.get_image(k) for k in keys])]
    common = dict(max_steps=DECODE_STEPS, cls_id=tz.cls_id, sep_id=tz.sep_id,
                  mask_id=tz.mask_id, pad_id=tz.pad_id)
    decoders = {
        "greedy_full": lambda: cap.greedy_decode(cap.StepInputs, model, *inp, **common),
        "greedy_cached": lambda: dc.greedy_decode_cached(model, *inp, **common),
        "beam5_full": lambda: cap.beam_search_decode(cap.StepInputs, model, *inp,
                                                     num_beams=DECODE_BEAMS, **common),
        "beam5_cached": lambda: cap.beam_search_decode(dc.CachedSteps, model, *inp,
                                                       num_beams=DECODE_BEAMS, **common)}
    got = {k: fn() for k, fn in decoders.items()}
    margin = decision_margins(model, got["greedy_full"][0], inp, common)
    decode = {"batch": DECODE_IMAGES, "steps": DECODE_STEPS, "f32": {},
              "greedy_min_top1_margin": margin, "logp_rtol": DECODE_F32_RTOL}
    for mode in ("greedy", "beam5"):
        (ft, fl), (ct, cl) = got[f"{mode}_full"], got[f"{mode}_cached"]
        rel = ((fl - cl).abs() / fl.abs().clamp(min=1e-6)).max().item()
        decode["f32"][mode] = {"tokens_equal": bool(torch.equal(ft, ct)), "logp_max_rel": rel,
                               "caption_0": cap_cli.detokenize(tok, ft[:1].cpu().numpy())[0]}
        if not (torch.equal(ft, ct) and rel <= DECODE_F32_RTOL):
            raise AssertionError(f"caption: cached {mode} disagrees with full recompute: "
                                 f"{decode} {ft.tolist()} {ct.tolist()}")
    for k in ("greedy_full", "greedy_cached"):  # beam 5 is checked, not timed
        decode["f32"][k + "_time"] = timed_decode(decoders[k], DECODE_STEPS)
    part_s["c_decode_f32"] = time.perf_counter() - t_part

    # (d) bf16 full recompute with fused_attention against without
    t_part = time.perf_counter()
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, got
    fresh_memory()
    bf16 = {}
    for fused in (True, False):
        m = cap.BertImageCaptioner(dataclasses.replace(cfg, fused_attention=fused))
        m.load_state_dict(state)
        bf16[fused] = m.to(device="cuda", dtype=torch.bfloat16).eval()
    (ft, fl), launches_d = counted(
        lambda: cap.greedy_decode(cap.StepInputs, bf16[True], *inp, **common))
    pt, pl = cap.greedy_decode(cap.StepInputs, bf16[False], *inp, **common)
    want_k2 = cfg.num_hidden_layers * DECODE_STEPS
    diff = (fl.float() - pl.float()).abs().max().item()
    decode["bf16_fused_vs_plain"] = {
        "tokens_equal": bool(torch.equal(ft, pt)), "logp_max_abs_diff": diff,
        "logp_atol": DECODE_BF16_ATOL, "k2_forward_launches": launches_d["k2_fwd"],
        "plain_min_top1_margin": decision_margins(bf16[False], pt, inp, common),
        "fused_time": timed_decode(
            lambda: cap.greedy_decode(cap.StepInputs, bf16[True], *inp, **common), DECODE_STEPS),
        "plain_time": timed_decode(
            lambda: cap.greedy_decode(cap.StepInputs, bf16[False], *inp, **common), DECODE_STEPS)}
    if not (torch.equal(ft, pt) and diff <= DECODE_BF16_ATOL
            and launches_d["k2_fwd"] == want_k2 and launches_d["k2_bwd"] == 0):
        raise AssertionError(f"caption: bf16 decode with K2 disagrees: {decode} "
                             f"(want {want_k2} K2 forwards) {ft.tolist()} {pt.tolist()}")
    out["decode"] = decode
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    part_s["d_decode_bf16"] = time.perf_counter() - t_part
    out["seconds"] = part_s
    emit({"phase": "caption", **out})
    del bf16
    fresh_memory()
    return {"step_launches": launches, "decode_launches": launches_d}


RETRIEVAL_IMAGES, RETRIEVAL_ANCHORS, RETRIEVAL_LR = 32, 16, 2e-5


def phase_retrieval_oscar(tmp: str, vocab_dir: str) -> dict:
    """cli/retrieval_oscar at VinVL-base width over a synthetic corpus of 32
    images: one epoch of pair steps at 16 anchors (32 rows x (70 text + 50
    regions)), then evaluate_cross over 32 images x 160 captions (5120
    pairs): finite losses, R@K; ms a step (f32, knobs off), the cross
    evaluation's pairs/s with its host tensorize and card time; one bf16
    pair step with K2 + K3a on against off at dropout 0, and the launches
    of a step."""
    import torch

    from aladin_torch.cli import pretrain as pretrain_cli
    from aladin_torch.cli import retrieval_oscar as ro_cli
    from aladin_torch.cli.common import build_tokenizer
    from aladin_torch.config import DataArgs
    from aladin_torch.data.dataset import RetrievalDataset
    from aladin_torch.models.bert_img import ImageBertClassifier
    from aladin_torch.tasks import retrieval_oscar as ro

    root = os.path.join(tmp, "ro_corpus")
    caption_corpus(root, RETRIEVAL_IMAGES)
    fresh_memory()
    t0 = time.perf_counter()
    res = ro_cli.run(["--data_dir", root, "--eval_model_dir", vocab_dir, "--output_dir",
                      os.path.join(tmp, "ro_run"), "--train_batch_size", str(RETRIEVAL_ANCHORS),
                      "--epochs", "1", "--device", "cuda"])
    cli_seconds = time.perf_counter() - t0
    cfg = res["model"].bert.cfg
    check_width("retrieval_oscar", cfg)
    losses = [m["loss"] for m in res["metrics"]]
    steps = RETRIEVAL_IMAGES * 5 // RETRIEVAL_ANCHORS
    if len(losses) != steps or not all(math.isfinite(v) for v in losses) or not (
            0.0 <= res["results"]["rsum"] <= 600.0):
        raise AssertionError(f"retrieval_oscar: losses {losses}, results {res['results']}")
    out = {"card": nvidia_smi_line(), "rows": 2 * RETRIEVAL_ANCHORS, "seq": "70 text + 50 regions",
           "cli_seconds": cli_seconds, "losses_first_last": [losses[0], losses[-1]],
           "results": res["results"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    model, batch = res["model"], res["batch"]
    out["f32_knobs_off"] = step_times(res["step"], batch)
    del res

    # the cross evaluation again, timed: its host tensorize alone, the card
    args = DataArgs(data_dir=root, img_feat_file=os.path.join(root, "features.tsv"),
                    eval_model_dir=vocab_dir, add_od_labels=True)
    test_ds = RetrievalDataset(build_tokenizer(args), args, "test", is_train=False)
    keys, n = test_ds.img_keys, len(test_ds.img_keys)
    pairs = n * n * 5
    t0 = time.perf_counter()
    feats = {k: test_ds.get_image(k) for k in keys}
    for i in range(n):
        for c in range(n * 5):
            test_ds.tensorizer.tensorize_joint(test_ds.captions[keys[c // 5]][c % 5],
                                               test_ds.get_od_labels(keys[i]), feats[keys[i]])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = ro.evaluate_cross(model, test_ds)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    card = device_profile(lambda: ro.evaluate_cross(model, test_ds), 1, top=4)
    out["cross_eval"] = {"pairs": pairs, "seconds": total_s, "pairs_per_s": pairs / total_s,
                         "repeats_the_cli_results": again == out["results"],
                         "host_tensorize_s": host_s, "card_s": card["device_ms"] / 1e3,
                         "card_busy_share": card["device_ms"] / 1e3 / total_s,
                         "top": card["top"]}

    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    fresh_memory()

    def build(fused: bool, dropout: float):
        c = dataclasses.replace(cfg, fused_attention=fused, fused_layernorm=fused,
                                hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
        m = ImageBertClassifier(c)
        m.load_state_dict(start)
        m.cuda()
        opt, _ = pretrain_cli.make_optimizer(m, RETRIEVAL_LR, 0, 10)
        return m, ro.make_pair_train_step(m, opt, "ce", torch.bfloat16)

    knobs = knob_check("retrieval_oscar", build, batch, start, RETRIEVAL_LR)
    out["knob_check_dropout0"] = knobs["agreement"]
    out["bf16_knobs_on"], out["bf16_knobs_off"] = knobs["on_times"], knobs["off_times"]
    fresh_memory()
    m, step = build(True, 0.1)
    metrics, launches = counted(lambda: step(*batch))
    want = step_launches(cfg.num_hidden_layers, False, passes=1)
    if launches != want or not math.isfinite(metrics["loss"].item()):
        raise AssertionError(f"retrieval_oscar: launches {launches}, expected {want}; {metrics}")
    out["launches_step_dropout0.1"] = launches
    emit({"phase": "retrieval_oscar", **out})
    del m, step
    fresh_memory()
    return {"launches": launches}


def _kda_inputs(gen, lengths, h=32, d=128):
    """Raw KDA inputs at the published widths for documents packed end to
    end, in bf16 (projections of unit rows through normal(0, 0.02) matrices
    of width 2304: ~0.96 rms; f as the low-rank decay projection, ~0.4),
    and the layer's per-channel weights as the benchmark draws them."""
    import torch
    from aladin_torch.ops.kernels import kda

    n = sum(lengths)
    q, k, v = (torch.randn(n, h * d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    f = (0.4 * torch.randn(n, h * d, generator=gen, device="cuda")).bfloat16()
    b = torch.randn(n, h, generator=gen, device="cuda").bfloat16()
    conv = (torch.rand(3, h * d, 4, generator=gen, device="cuda") - 0.5).bfloat16()
    a_log = torch.log(1 + 15 * torch.rand(h, generator=gen, device="cuda"))
    dt = torch.exp(math.log(1e-3) + torch.rand(h * d, generator=gen, device="cuda")
                   * math.log(100.0))
    return q, k, v, f, b, kda.Weights(conv, a_log, dt + torch.log(-torch.expm1(-dt)))


def _kda_ref_features(ref, q, k, v, f, b, w, d=128):
    """The reference's KDA inputs in float32 from one document's raw
    projections: ``reference/kimi_linear.py``'s convolution, then the norms,
    decay and beta as its layer computes them."""
    import torch

    t, width = q.shape
    h = width // d
    qf, kf, vf = (ref.short_conv(x.float(), w.conv[i].float()).reshape(t, h, d)
                  for i, x in enumerate((q, k, v)))
    qf = qf * torch.rsqrt(qf.pow(2).sum(-1, keepdim=True) + 1e-6) / math.sqrt(d)
    kf = kf * torch.rsqrt(kf.pow(2).sum(-1, keepdim=True) + 1e-6)
    g = (-torch.exp(w.a_log)[:, None]
         * torch.nn.functional.softplus(f.float() + w.dt_bias).reshape(t, h, d))
    return qf, kf, vf, g, torch.sigmoid(b.float())


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def phase_kda() -> dict:
    import torch
    from aladin_torch.ops.kernels import kda
    from aladin_torch.tasks import decode_cache
    from aladin_torch.utils import profiling
    from h100_bench.lib import harness, kda_bounds
    from h100_bench.reference import kimi_linear as ref

    dc = harness.load_runner(ROOT, "doc_condense")
    bench = os.path.join(ROOT, "h100_bench")
    with open(os.path.join(bench, "configs", "kimi-linear-48b-a3b-ep4.json")) as fh:
        c = json.load(fh)
    with open(os.path.join(bench, "traffic", "condense_doc64.json")) as fh:
        tr = json.load(fh)
    lengths = [int(x) + tr["instruction_tokens"]
               for x in dc.document_lengths(tr["document_tokens"], tr["batch"])]
    docs, tokens = len(lengths), sum(lengths)
    gen = torch.Generator(device="cuda").manual_seed(25)
    q, k, v, f, b, w = _kda_inputs(gen, lengths)
    perm = torch.randperm(docs, generator=torch.Generator().manual_seed(25)).tolist()
    lengths = [lengths[i] for i in perm]  # the packed order of a batch: mixed
    cu_host = [0]
    for x in lengths:
        cu_host.append(cu_host[-1] + x)
    cu = torch.tensor(cu_host, dtype=torch.int32, device="cuda")
    rows = torch.arange(docs, device="cuda")
    state = torch.full((docs, 32, 128, 128), float("nan"), device="cuda")
    tails = torch.zeros(docs, 3, 3 * 4096, dtype=torch.bfloat16, device="cuda")
    out = {"tokens": tokens, "docs": docs, "longest": max(lengths)}
    with torch.no_grad():
        o = kda.kda_prefill(q, k, v, f, b, w, cu, rows, state, tails)
        torch.cuda.synchronize()
        # the plain version on the two shortest documents (a token loop)
        short = sorted(range(docs), key=lambda i: lengths[i])[:2]
        sel = torch.cat([torch.arange(cu_host[i], cu_host[i + 1], device="cuda") for i in short])
        sub = [x[sel].contiguous() for x in (q, k, v, f, b)]
        sub_cu = torch.tensor([0, lengths[short[0]], lengths[short[0]] + lengths[short[1]]],
                              dtype=torch.int32, device="cuda")
        p_state = torch.empty(2, 32, 128, 128, device="cuda")
        p_tails = torch.empty(2, 3, 3 * 4096, dtype=torch.bfloat16, device="cuda")
        t0 = time.perf_counter()
        p_o = kda.kda_prefill_plain(*sub, w, sub_cu, torch.arange(2, device="cuda"), p_state,
                                    p_tails)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = {"k5_o_plain": _rel(o[sel], p_o),
               "k5_state_plain": max(_rel(state[i], p_state[j]) for j, i in enumerate(short))}
        if not all(torch.equal(tails[i], p_tails[j]) for j, i in enumerate(short)):
            raise AssertionError("kda: K5's tails differ from the plain version's")
        # the chunked reference on the longest document and three others
        longest = max(range(docs), key=lambda i: lengths[i])
        err["k5_o_chunked"] = err["k5_state_chunked"] = 0.0
        for i in [longest] + [x for x in perm[:4] if x != longest][:3]:
            s = slice(cu_host[i], cu_host[i + 1])
            feats = _kda_ref_features(ref, q[s], k[s], v[s], f[s], b[s], w)
            want_o, want_s = ref.kda_chunked(*(x[None] for x in feats))
            err["k5_o_chunked"] = max(err["k5_o_chunked"],
                                      _rel(o[s].reshape(want_o.shape[1:]), want_o[0]))
            err["k5_state_chunked"] = max(err["k5_state_chunked"],
                                          _rel(state[i].transpose(-1, -2), want_s[0]))
        for i in range(docs):
            raw = torch.cat([q[cu_host[i]:cu_host[i + 1]], k[cu_host[i]:cu_host[i + 1]],
                             v[cu_host[i]:cu_host[i + 1]]], dim=1)[-3:]
            if not torch.equal(tails[i], raw):
                raise AssertionError(f"kda: document {i}'s tails are not its last 3 raw rows")
        # K6 at batch 64 from those states, three steps against the plain version
        s_plain, t_plain = state.clone(), tails.clone()
        err["k6_o_plain"] = err["k6_state_plain"] = 0.0
        step_in = None
        for _ in range(3):
            step_in = _kda_inputs(gen, [docs])[:5]
            o6 = kda.kda_step(*step_in, w, state, tails)
            want6 = kda.kda_step_plain(*step_in, w, s_plain, t_plain)
            torch.cuda.synchronize()
            err["k6_o_plain"] = max(err["k6_o_plain"], _rel(o6, want6))
            err["k6_state_plain"] = max(err["k6_state_plain"], _rel(state, s_plain))
            if not torch.equal(tails, t_plain):
                raise AssertionError("kda: K6's tails differ from the plain version's")
        out["max_rel_err"] = err
        limits = {"k5_o_plain": KDA_O_RTOL, "k5_state_plain": KDA_PLAIN_S_RTOL,
                  "k5_o_chunked": KDA_O_RTOL, "k5_state_chunked": KDA_CHUNKED_S_RTOL,
                  "k6_o_plain": KDA_O_RTOL, "k6_state_plain": KDA_STEP_S_RTOL}
        over = {n: (err[n], lim) for n, lim in limits.items() if not err[n] <= lim}
        if over:
            raise AssertionError(f"kda: over the tolerances {over}")
        # times at the cell's shapes beside the bounds
        k5_ms = cuda_ms(lambda: kda.kda_prefill(q, k, v, f, b, w, cu, rows, state, tails), 3)
        k6_ms = device_ms(lambda: kda.kda_step(*step_in, w, state, tails), 50)
        sp, tp = state[:1].clone(), tails[:1].clone()
        one = [x[:1].contiguous() for x in step_in]
        t0 = time.perf_counter()
        kda.kda_step_plain(*one, w, sp, tp)
        torch.cuda.synchronize()
        k6_plain_ms = 1e3 * (time.perf_counter() - t0) * docs
    out["timings"] = {
        "k5": {"ms": k5_ms, "bound_ms": 1e3 * kda_bounds.k5_bound_s(c, tokens, docs),
               "bound_by": "bytes",
               # the plain version's seconds on the two documents, scaled by tokens
               "plain_ms": 1e3 * plain_s * tokens / sel.numel(), "library_ms": None,
               "shape": f"{docs} documents, {tokens} tokens packed, H32 d128 bf16"},
        "k6": {"ms": k6_ms, "bound_ms": 1e3 * kda_bounds.k6_bound_s(c, docs),
               "bound_by": "bytes", "plain_ms": k6_plain_ms, "library_ms": None,
               "shape": f"B{docs} H32 d128, state f32"}}
    del q, k, v, f, b, o, state, tails, s_plain, t_plain
    fresh_memory()
    # the main path: a cut Kimi-Linear through greedy_decode_cached
    cut = dict(c, num_hidden_layers=4, vocab_size=1024,
               linear_attn_config=dict(c["linear_attn_config"], full_attn_layers=[4],
                                       kda_layers=[1, 2, 3]))
    model = dc.port_model(cut, 25, torch.device("cuda"))
    mixed = [700, 40, 2100, 7, 65, 1300, 23, 511]
    ids = torch.randint(0, 1000, (sum(mixed),), generator=gen, device="cuda")
    steps = 16
    with torch.no_grad():
        first = decode_cache.greedy_decode_cached(model, ids, mixed, max_steps=steps)
        before = profiling.counters()
        again = decode_cache.greedy_decode_cached(model, ids, mixed, max_steps=steps)
        torch.cuda.synchronize()
        after = profiling.counters()
        launches = {n: after[n] - before.get(n, 0)
                    for n in ("k5.launches", "k6.launches", "decode.prefill_pad_tokens")}
        card = device_profile(lambda: decode_cache.greedy_decode_cached(
            model, ids, mixed, max_steps=steps), 1, top=60)
    kda_layers = model.kda_layers
    by_name = {pat: sum(r["calls"] for r in card["top"] if pat in r["name"])
               for pat in ("kda_prefill_k5", "kda_step_k6")}
    want = {"k5.launches": kda_layers, "k6.launches": kda_layers * (steps - 1),
            "decode.prefill_pad_tokens": 0}
    if launches != want or by_name != {"kda_prefill_k5": want["k5.launches"],
                                       "kda_step_k6": want["k6.launches"]}:
        raise AssertionError(f"kda: main-path launches {launches}, traced {by_name}; "
                             f"expected {want}")
    if not torch.equal(first[0], again[0]):
        raise AssertionError("kda: the second batch's tokens differ from the first's")
    out["main_path"] = {"launches": launches, "traced_calls": by_name, "steps": steps,
                        "documents": mixed}
    emit({"phase": "kda", **out})
    del model
    fresh_memory()
    return {"timings": out["timings"], "max_rel_err": err, "launches": launches}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "aladin_torch")):
        print("chip_smoke.py must run from a checkout of the repository (aladin_torch/ "
              "not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 comparisons in full f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_env()
    phase_build()
    k1 = phase_k1()
    corpus_dir = tempfile.TemporaryDirectory()  # the serving corpus, kept for parity at the end
    tmp = corpus_dir.name
    oscar, data, setup_s = serving_corpus(tmp)
    launches, main_bf16 = phase_main(tmp, oscar, data, setup_s)
    q8ln = phase_encode_q8ln(oscar, data)
    phase_search(tmp, oscar, data)
    streamed = phase_streaming()
    parallel = phase_parallel(tmp)
    k2 = phase_k2()
    k3 = phase_k3()
    k4 = phase_k4()
    k3b = phase_k3b()
    fused = phase_train_fused()["launches"]
    phase_train_graph()
    phase_train_cli()
    remat = phase_train_levers()["remat_launches"]
    phase_variants()
    with tempfile.TemporaryDirectory() as tmp:
        vocab_dir = os.path.join(tmp, "vocab")
        write_vocab_dir(vocab_dir)
        pretrain = phase_pretrain(tmp, vocab_dir)["launches"]
        phase_classify(tmp, vocab_dir)
        caption = phase_caption(tmp, vocab_dir)
        pair = phase_retrieval_oscar(tmp, vocab_dir)["launches"]
    # the PR 14 phases run last, so that the earlier phases keep their order
    parity_k1 = phase_parity(corpus_dir.name, oscar, data, main_bf16)["k1_launches"]
    del main_bf16
    phase_data_smoke(oscar, data)
    corpus_dir.cleanup()
    with tempfile.TemporaryDirectory() as tmp:
        tp = phase_tensor_parallel(tmp)
    kda_out = phase_kda()
    # K1 runs on four paths: cli/test's scoring, cli/parity's, streaming
    # alignment recall, and the sharded scorer and mesh sweep of the
    # parallel phase
    k1_launches = {"bf16": launches["bf16"]["k1"] + parity_k1 + streamed["k1_launches"]
                   + parallel["k1_launches"]["bf16"],
                   "int8": launches["int8"]["k1"] + parallel["k1_launches"]["int8"]}
    k1_err = {"bf16": max(k1["max_err"]["bf16"], streamed["k1_max_err"],
                          parallel["k1_max_err"]["bf16"]),
              "int8": max(k1["max_err"]["int8"], parallel["k1_max_err"]["int8"])}
    kernels = [{
        "name": f"mrsw_scores ({name})", "route": "cuda", "source": "aladin_torch/csrc/mrsw_kernel.cu",
        "replaces": "aladin_tpu/ops/pallas/alignment_kernel.py:59",
        "launches": k1_launches[name],
        "max_abs_err": k1_err[name], "ms": k1["timings"][name]["ms"],
        "plain_ms": k1["timings"][name]["plain_ms"], "bound_ms": k1["timings"][name]["bound_ms"],
        "bound_by": k1["timings"][name]["bound_by"], "library_ms": None,
    } for name in ("bf16", "int8")]
    # K2 and K3a times at the longer of the path's two sequences (S 84)
    for name, key, line in (("fused_attention forward", "fwd", 79),
                            ("fused_attention backward", "bwd", 88)):
        t = k2["timings"][84][key]
        kernels.append({
            "name": name, "route": "cuda", "source": "aladin_torch/csrc/attention_kernel.cu",
            "replaces": f"aladin_tpu/ops/pallas/attention_kernel.py:{line}",
            "launches": fused[f"k2_{key}"], "launches_remat_step": remat[f"k2_{key}"],
            "launches_pretrain_step": pretrain[f"k2_{key}"],
            "launches_caption_step": caption["step_launches"][f"k2_{key}"],
            "launches_pair_step": pair[f"k2_{key}"],
            **({"launches_caption_decode": caption["decode_launches"]["k2_fwd"]}
               if key == "fwd" else {}),
            "max_abs_err": k2["max_err"][key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": "B128 S84 H12 d64 bf16",
            **{name: {"shape": shape, **k2["block_masks"][shape][key]}
               for name, shape in (("caption_shape", CAPTION_K2_SHAPE),
                                   ("decode_shape", DECODE_K2_SHAPE))}})
    # K2 on one tensor-parallel rank's heads (H 6 of 12, head_offset 6):
    # launches a rank in one tp step
    for name, key, line in (("fused_attention forward, tp rank heads", "fwd", 79),
                            ("fused_attention backward, tp rank heads", "bwd", 88)):
        t = tp["k2"]["timings"]["B128 S84 H6 of 12 d64 bf16"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": "aladin_torch/csrc/attention_kernel.cu",
            "replaces": f"aladin_tpu/ops/pallas/attention_kernel.py:{line}",
            "launches": tp["launches"][f"k2_{key}"], "max_abs_err": tp["k2"]["max_err"][key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": "B128 S84 H6 of 12 (head_offset 6) d64 bf16"})
    t = k3["timings"][84]
    kernels.append({
        "name": "residual_layernorm forward", "route": "triton",
        "source": "aladin_torch/ops/kernels/layernorm.py",
        "replaces": "aladin_tpu/ops/pallas/layernorm.py:70", "launches": fused["k3a"],
        "launches_remat_step": remat["k3a"], "launches_pretrain_step": pretrain["k3a"],
        "launches_caption_step": caption["step_launches"]["k3a"],
        "launches_pair_step": pair["k3a"],
        "max_abs_err": k3["max_err"]["fwd"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": "M10752 D768 bf16"})
    kernels.append({
        "name": "residual_layernorm backward", "route": "cuda",
        "source": "aladin_torch/csrc/layernorm_kernel.cu",
        "replaces": "aladin_tpu/ops/pallas/layernorm.py:193", "launches": fused["k3a_bwd"],
        "launches_remat_step": remat["k3a_bwd"], "launches_pretrain_step": pretrain["k3a_bwd"],
        "launches_caption_step": caption["step_launches"]["k3a_bwd"],
        "launches_pair_step": pair["k3a_bwd"],
        "max_abs_err": k3["max_err"]["bwd"], "ms": t["backward_ms"],
        "plain_ms": t["backward_plain_ms"], "bound_ms": t["backward_bound_ms"],
        "bound_by": t["backward_bound_by"], "library_ms": t["backward_library_ms"],
        "shape": "M10752 D768 bf16"})
    # K3b and K4 from the q8ln encode, K4-dynx from cli/test --int8_encoder;
    # times at the image pass's M 2688 (the QKV shape for K4)
    t = k3b["timings"][2688]
    kernels.append({
        "name": "residual_layernorm_q8", "route": "cuda",
        "source": "aladin_torch/csrc/layernorm_kernel.cu",
        "replaces": "aladin_tpu/ops/pallas/layernorm.py:79", "launches": q8ln["k3b"],
        "max_abs_err": k3b["max_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": "M2688 D768 bf16"})
    for name, key, line, count in (("w8a8_matmul", "k4", 70, q8ln["k4"]),
                                   ("w8a8_matmul_dynx", "k4_dynx", 76,
                                    launches["int8_encoder"]["k4_dynx"])):
        t = k4["timings"]["qkv M2688"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": "aladin_torch/csrc/quant_matmul.cu",
            "replaces": f"aladin_tpu/ops/pallas/quant_matmul.py:{line}", "launches": count,
            "max_abs_err": k4["max_err"][key], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": "M2688 K768 N2304 bf16 out"})
    # K5 and K6 at the condense cell's shapes; launches of one main-path batch
    # of the cut model (K6: replays of the step graphs)
    for name, key, counter, err_o, err_s in (
            ("kda_prefill", "k5", "k5.launches", "k5_o_chunked", "k5_state_chunked"),
            ("kda_step", "k6", "k6.launches", "k6_o_plain", "k6_state_plain")):
        t = kda_out["timings"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": "aladin_torch/csrc/kda_kernel.cu",
            "replaces": None, "launches": kda_out["launches"][counter],
            "max_rel_err": {"o": kda_out["max_rel_err"][err_o],
                            "state": kda_out["max_rel_err"][err_s]},
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--tp-rank":
        sys.exit(tp_rank_main(int(sys.argv[2]), int(sys.argv[4]), sys.argv[6]))
    sys.exit(main())
