#!/usr/bin/env python3
"""Time source variants of the W8A8 GEMM and its dynx quantize (K4 and
K4-dynx, csrc/quant_matmul.cu) on one CUDA card, at the int8 encoder's
shapes: M 2688 and 1600 (the image and caption passes at bs 32), K 768,
N 2304 (QKV) and 3072 (FFN-up, gelu), bf16 out.

    python3 tools/k4_variants.py

Each variant is the kernel source with one design constant or line
changed (the output tile width, the ring's depth, the dynx chaining, the
quantize's division). Design variants are checked bit for bit against the
unchanged source (the GEMM's y, the quantize's xq and scales, the latter
also on every finite bf16 value); "diagnostic" variants leave out one part
of the work (the wgmma, the TMA loads, the epilogue, the y stores) to show
what that part costs, and are not checked. All variants are built with nvcc in parallel
and timed as chip_smoke.py times the kernels (card time of calls queued
behind a spin kernel, 50 calls). The unchanged source runs first and last,
so the two give the run's spread. Prints one JSON line per variant, then
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_LOADS = [("          mbar_expect_bytes(&full[stage], C::kStageBytes);",
             "          mbar_arrive(&full[stage]);"),
            ("          tma_load(st, &map_x, c * kChunk, o.x, &full[stage]);", ""),
            ("          tma_load(st + kTileM * kChunk, &map_w, c * kChunk, o.y, &full[stage]);", "")]
NO_WGMMA = [("        wgmma(acc, da + 2 * s, db + 2 * s, (c > 0 || s > 0) ? 1 : 0);",
             "        acc[s] = static_cast<int>(da >> s);")]
NO_EPILOGUE = [("    for (int slab = 0; slab < BN / kSlabCols; ++slab) {",
                "    for (int slab = 0; slab < 0; ++slab) {")]
VARIANTS = {
    "as built": [],
    "ring: up to 8 stages (6 fit)": [("constexpr int kMaxStages = 4;",
                                      "constexpr int kMaxStages = 8;")],
    "tile width 192": [("constexpr int kTileN = 128;", "constexpr int kTileN = 192;")],
    "tile width 256": [("constexpr int kTileN = 128;", "constexpr int kTileN = 256;")],
    "dynx: GEMM not chained to the quantize": [("constexpr bool kChainDynx = true;",
                                                "constexpr bool kChainDynx = false;")],
    "quantize: IEEE divide (__fdiv_rn) for each value": [
        ("  return __fmaf_rn(__fmaf_rn(-scale, q, x), inv, q);", "  return __fdiv_rn(x, scale);")],
    "diagnostic: no y stores": [("      for (int v = 0; v < 16 * kPiecesRow / 32; ++v) {",
                                 "      for (int v = 0; v < 0; ++v) {")],
    "diagnostic: no TMA loads": NO_LOADS,
    "diagnostic: no wgmma": NO_WGMMA,
    "diagnostic: no epilogue": NO_EPILOGUE,
    "diagnostic: no TMA loads, no wgmma, no epilogue": NO_LOADS + NO_WGMMA + NO_EPILOGUE,
    "as built, again": [],
}


def bf16_values(device):
    """Every finite bf16 value, in rows of 768: row e holds the 768 values of
    binades e, e + 1 and e + 2 (both signs, all 128 mantissas), e = 0..252,
    so each row's quotients x / scale spread over the whole int8 range and
    each value is quantized under three scales."""
    import torch

    mant = torch.arange(128, dtype=torch.int32)
    rows = []
    for e in range(253):
        exps = torch.arange(e, e + 3, dtype=torch.int32)
        mag = (exps[:, None] << 7 | mant[None]).reshape(-1)
        rows.append(torch.cat([mag, mag | 0x8000]))
    bits = torch.stack(rows).to(torch.int16)  # (253, 768)
    return bits.view(torch.bfloat16).to(device)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("k4_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from aladin_torch.ops.kernels import build
    from aladin_torch.ops.kernels import quant_matmul as qm

    with open(os.path.join(build.CSRC_DIR, "quant_matmul.cu")) as f:
        source = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "k4_variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", path[:-3] + ".so", path]
        jobs[name] = (path[:-3] + ".so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib_path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        notes = [line.strip() for line in log.splitlines()
                 if "arning" in line or "erformance" in line or "spill" in line.lower()
                 and " 0 bytes spill" not in line]
        lib = ctypes.CDLL(lib_path)
        lib.w8a8_matmul_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.w8a8_quantize_launch.argtypes = [p, i, p, p, i, i, p]
        lib.w8a8_matmul_dynx_launch.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, p]
        libs[name] = (lib, notes[:6])

    gen = torch.Generator(device="cuda").manual_seed(6)
    k = 768
    shapes = []
    for m in (2688, 1600):
        for n, act in ((2304, None), (3072, "gelu")):
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            wq, ws = qm.quantize_weight(0.03 * torch.randn(n, k, generator=gen, device="cuda"))
            b = 0.1 * torch.randn(n, generator=gen, device="cuda")
            xq, xs = qm.quantize_rowwise(x)
            shapes.append((f"M{m} N{n} {act}", x, xq, xs.reshape(-1).contiguous(), wq, ws, b,
                           qm._ACT_CODE[act]))
    adversarial = bf16_values("cuda")
    want = {}
    for name, (lib, notes) in libs.items():
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        row = {"variant": name, "nvcc_notes": notes, "ms": {}, "equal_to_as_built": True}
        for tag, x, xq, xs, wq, ws, b, act in shapes:
            m, n = x.shape[0], wq.shape[0]
            out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            dout = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
            sq = torch.empty(m, k, dtype=torch.int8, device="cuda")
            ss = torch.empty(m, dtype=torch.float32, device="cuda")

            def k4(lib=lib, xq=xq, xs=xs, wq=wq, ws=ws, b=b, out=out, m=m, n=n, act=act):
                err = lib.w8a8_matmul_launch(xq.data_ptr(), xs.data_ptr(), wq.data_ptr(),
                                             ws.data_ptr(), b.data_ptr(), out.data_ptr(), m, n,
                                             k, act, 0, stream())
                if err:
                    raise RuntimeError(f"variant {name!r}: launch failed ({err})")

            def dynx(lib=lib, x=x, wq=wq, ws=ws, b=b, out=dout, m=m, n=n, act=act):
                err = lib.w8a8_matmul_dynx_launch(x.data_ptr(), 0, sq.data_ptr(), ss.data_ptr(),
                                                  wq.data_ptr(), ws.data_ptr(), b.data_ptr(),
                                                  out.data_ptr(), m, n, k, act, 0, stream())
                if err:
                    raise RuntimeError(f"variant {name!r}: launch failed ({err})")

            row["ms"][f"k4 {tag}"] = chip_smoke.device_ms(k4, 50)
            row["ms"][f"k4_dynx {tag}"] = chip_smoke.device_ms(dynx, 50)
            got = (out.clone(), dout.clone())
            if name == "as built":
                want[tag] = got
            elif not name.startswith("diagnostic"):
                row["equal_to_as_built"] &= all(torch.equal(g, w) for g, w in zip(got, want[tag]))
        for tag, x in (("M2688", shapes[0][1]), ("all bf16 values", adversarial)):
            q = torch.empty(x.shape, dtype=torch.int8, device="cuda")
            sc = torch.empty(x.shape[0], dtype=torch.float32, device="cuda")

            def quant(lib=lib, x=x, q=q, sc=sc):
                err = lib.w8a8_quantize_launch(x.data_ptr(), 0, q.data_ptr(), sc.data_ptr(),
                                               x.shape[0], x.shape[1], stream())
                if err:
                    raise RuntimeError(f"variant {name!r}: quantize failed ({err})")

            row["ms"][f"quantize {tag}"] = chip_smoke.device_ms(quant, 50)
            wq_, ws_ = qm.quantize_rowwise_dynx(x)
            if not name.startswith("diagnostic"):
                row["equal_to_as_built"] &= bool(torch.equal(q, wq_)
                                                 and torch.equal(sc, ws_.reshape(-1)))
        chip_smoke.emit(row)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
