#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aladin_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. env    - torch/CUDA versions, the card's name and power limit, yaml.
  2. build  - every CUDA kernel of the serving path built from the sources
              in this checkout with nvcc (sm_90a), and the seconds taken.
  3. k1     - the MrSw all-pairs kernel (csrc/mrsw_kernel.cu) against its
              plain PyTorch version on the card: bf16 and int8, plain and
              length-bucketed, at 1000 x 5000 pairs with uniform lengths and
              at the shapes the main path gives it; the zero-floor case; a
              score's independence of the corpus shape; then its time at the
              5k x 25k benchmark shape.
  4. main   - the serving path end to end at VinVL-base width (12 layers,
              hidden 768, 2054-d regions) on random weights from a seed:
              aladin_torch.cli.test over 1000 images / 5000 captions, once
              with bf16 scoring and once with int8 scoring. Each run must
              launch the kernel and give finite metrics.

Then the kernels line ({"kernels": [...]}), the card's name and power limit
as nvidia-smi prints them, and last {"ok": true, "device": {...}}. Any failed
phase raises, so the script exits nonzero without that last line. It also
refuses to run without a CUDA device or outside the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RECIPE = "alad-alignment-and-matching-distill.json"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks
# bf16: kernel and plain version multiply the same bf16-rounded operands
# exactly in f32 and differ only in the order of the f32 sums over D=768 and
# over the words (~1e-6 on scores of O(10)); 1e-3 leaves that room and still
# catches a wrong row, word or mask. int8: both sum the same integers
# exactly, so only the f32 descale may round.
BF16_ATOL = 1e-3
INT8_RTOL = 1e-5


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
            want = ak.mrsw_scores_bucketed(*args, scorer=plain)
            max_err[name] = max(max_err[name], compare(tag + " bucketed", got, want, name))

    # zero floor: word 0 of caption 0 points against every region of images
    # 0 (full buffer: no floor, negative max) and 1 (short: floored at 0)
    im, cap, il, sl = corpus(gen, 4, 3, 34, 50)
    il[0], il[1] = 34, 10
    cap[0, 1] = -(im[0, 1:].sum(0) + im[1, 1:10].sum(0))
    for name, dt in dtypes.items():
        compare("zero floor", ak.mrsw_scores(im, cap, il, sl, compute_dtype=dt),
                ak.mrsw_scores_plain(im, cap, il, sl, compute_dtype=dt), name)

    # a score does not depend on the corpus shape (bf16: no per-call scales)
    args = corpus(gen, *shapes["1000x5000 S34/50"])
    full = ak.mrsw_scores(*args)
    part = ak.mrsw_scores(args[0][100:300], args[1][1000:2500], args[2][100:300],
                          args[3][1000:2500])
    if not torch.equal(part, full[100:300, 1000:2500]):
        raise AssertionError("K1 scores changed with the corpus shape")

    # kernel and plain time on the prepared operands of the comparison shape
    timings = {}
    for name, dt in dtypes.items():
        im_p, cap_p, _ = ak._prepare(*args, dt)
        bound_ms, bound_by = mrsw_bound(args, name)
        timings[name] = {
            "ms": cuda_ms(lambda: ak._launch(im_p, cap_p), 5),
            "plain_ms": cuda_ms(lambda: ak._plain_core(im_p, cap_p), 2),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    emit({"phase": "k1", "checks": checks, "shape_independent": True,
          "bf16_atol": BF16_ATOL, "int8_rtol": INT8_RTOL, "timings_1000x5000": timings})

    # the benchmark shape: 5k x 25k, S_im 34, S_s 50, D 768, uniform lengths
    bench = corpus(gen, 5000, 25000, 34, 50)
    bench_out = {}
    for name, dt in dtypes.items():
        im_p, cap_p, _ = ak._prepare(*bench, dt)
        ms = cuda_ms(lambda: ak._launch(im_p, cap_p), 2)
        bench_out[name] = {"ms": ms, "m_pairs_per_s": 5000 * 25000 / ms / 1e3,
                           "bound_ms": mrsw_bound(bench, name)[0],
                           "wrapper_ms": cuda_ms(lambda: ak.mrsw_scores(*bench, compute_dtype=dt),
                                                 1)}
    del bench
    emit({"phase": "k1_bench", "shape": "5000x25000 S34/50 D768", "kernel": bench_out,
          "library_ms": None,
          "library_note": "no single PyTorch call computes MrSw (max over regions, sum over words)"})
    return {"max_err": max_err, "timings": timings}


def write_oscar_dir(path: str, vocab) -> None:
    """A VinVL-base-shaped OSCAR directory with random weights from a seed."""
    import torch

    from aladin_torch.models.bert_img import BertImgConfig, BertImgModel

    cfg = BertImgConfig()  # 12 layers, hidden 768, 12 heads, FFN 3072, vocab 30522, 2054-d
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


def time_loader(oscar_dir: str, data: str) -> float:
    """Seconds to read, tensorize and copy the encode batches to the card
    without running the model: the host data path's share of encode."""
    import torch

    from aladin_torch.cli.common import build_tokenizer
    from aladin_torch.config import DataArgs
    from aladin_torch.data.dataset import RetrievalDataset
    from aladin_torch.data.pipeline import BatchLoader

    args = DataArgs(data_dir=data, img_feat_file=os.path.join(data, "features.tsv"),
                    eval_model_dir=oscar_dir, max_seq_length=50, max_img_seq_length=34,
                    add_od_labels=True, eval_img_keys_file="test_img_keys.tsv")
    ds = RetrievalDataset(build_tokenizer(args), args, "test", is_train=False)
    loader = BatchLoader(ds, 32, shuffle=False, drop_last=False, device="cuda")
    t0 = time.perf_counter()
    for _ in loader.epoch(0):
        pass
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_main() -> dict:
    import math

    import torch

    from aladin_torch.cli import test as cli_test
    from aladin_torch.data.dataset import make_synthetic_dataset
    from aladin_torch.ops.kernels.alignment_kernel import mrsw_scores

    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "of", "the", "dog",
              "cat", "car", "tree", "person", "boat", "bird", "house", "number"]
             + [str(i) for i in range(10)])
    launches, results = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_oscar_dir(os.path.join(tmp, "oscar"), vocab)
        data = os.path.join(tmp, "coco_ir")
        make_synthetic_dataset(data, n_images=1000, feat_dim=2054)
        setup_s = time.perf_counter() - t0
        common = [
            "--config", os.path.join(ROOT, "aladin_torch", "configs", RECIPE),
            "--eval_model_dir", os.path.join(tmp, "oscar"), "--data_dir", data,
            "--img_feat_file", os.path.join(data, "features.tsv"),
            "--eval_img_keys_file", "test_img_keys.tsv", "--max_seq_length", "50",
            "--max_img_seq_length", "34", "--add_od_labels", "--output_dir", tmp,
            "--logger_name", tmp, "--device", "cuda",
        ]
        for name, extra in (("bf16", []), ("int8", ["--compute_dtype", "int8"])):
            mrsw_scores.launches = 0
            res = cli_test.run(common + extra)
            launches[name] = mrsw_scores.launches
            results[name] = res
            if launches[name] == 0:
                raise AssertionError(f"{name} run never launched the MrSw kernel")
        loader_s = time_loader(os.path.join(tmp, "oscar"), data)
    for name, res in results.items():
        metrics = {**{f"matching_{k}": v for k, v in res["matching"].items()},
                   **{f"alignment_i2t_{k}": v for k, v in res["alignment_i2t"].items()},
                   **{f"alignment_t2i_{k}": v for k, v in res["alignment_t2i"].items()}}
        scores = res["scores"]
        if scores.shape != (1000, 5000) or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{name} run: bad scores {scores.shape} or metrics {metrics}")
        emit({"phase": "main", "scoring": name, "images": 1000, "captions": 5000,
              "setup_seconds": setup_s, "encode_seconds": res["encode_seconds"],
              "loader_only_seconds": loader_s,
              "score_seconds": res["score_seconds"], "kernel_launches": launches[name],
              "metrics": metrics})
    a = torch.from_numpy(results["bf16"]["scores"]).double().flatten()
    b = torch.from_numpy(results["int8"]["scores"]).double().flatten()
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    if not corr > 0.999:
        raise AssertionError(f"int8 and bf16 alignment scores disagree (corr {corr})")
    emit({"phase": "main_check", "bf16_int8_score_corr": corr})
    return launches


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
    launches = phase_main()
    kernels = [{
        "name": f"mrsw_scores ({name})", "route": "cuda", "source": "aladin_torch/csrc/mrsw_kernel.cu",
        "replaces": "aladin_tpu/ops/pallas/alignment_kernel.py:59", "launches": launches[name],
        "max_abs_err": k1["max_err"][name], "ms": k1["timings"][name]["ms"],
        "plain_ms": k1["timings"][name]["plain_ms"], "bound_ms": k1["timings"][name]["bound_ms"],
        "bound_by": k1["timings"][name]["bound_by"], "library_ms": None,
    } for name in ("bf16", "int8")]
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
