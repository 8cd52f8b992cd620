#!/usr/bin/env python3
"""Time source variants of the residual LayerNorm kernels (K3b and K3a's
backward, csrc/layernorm_kernel.cu) on one CUDA card, at the path's shapes:
K3b at M 2688 and 1600 (the q8ln encoder's image and caption passes at
bs 32), the backward at M 10752 and 6400 (the train step's at B 128), D 768,
bf16 x and res.

    python3 tools/ln_variants.py

Each variant is the kernel source with one design constant or line changed
(K3b's division and rows a block; the backward's warps a block, its
prefetch of the next row, its register bound, the chaining of its
partial-row sum). Variants are checked bit for
bit against the unchanged source on K3b's (y, q, s) and the backward's dx;
the backward's dgamma / dbeta are summed in an order that depends on the
grid, so they are held to 1e-5 of the largest. All variants are built with
nvcc in parallel and timed as chip_smoke.py times the kernels (card time of
calls queued behind a spin kernel, 50 calls). The unchanged source runs
first and last, so the two give the run's spread. Prints one JSON line per
variant, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "as built": [],
    "K3b: IEEE divide (__fdiv_rn) for each value": [
        ("  return -__fmaf_rn(-__fmaf_rn(-scale, q, x), inv, -q);",
         "  return __fdiv_rn(x, scale);")],
    "K3b: 8 warps a block": [("constexpr int kQ8Warps = 4;", "constexpr int kQ8Warps = 8;")],
    "K3b: 2 warps a block": [("constexpr int kQ8Warps = 4;", "constexpr int kQ8Warps = 2;")],
    "backward: 4 warps a block": [("constexpr int kBwdWarps = 8;", "constexpr int kBwdWarps = 4;")],
    "backward: no prefetch of the next row": [
        ("constexpr bool kPrefetchRow = true;", "constexpr bool kPrefetchRow = false;")],
    "backward: no prefetch, two blocks an SM": [
        ("constexpr bool kPrefetchRow = true;", "constexpr bool kPrefetchRow = false;"),
        ("constexpr int kBwdBlocksPerSM = 1;", "constexpr int kBwdBlocksPerSM = 2;")],
    "backward: prefetch, two blocks an SM": [
        ("constexpr int kBwdBlocksPerSM = 1;", "constexpr int kBwdBlocksPerSM = 2;")],
    "backward: f32's chunk layout for every type": [
        ("    const bool wide = x_dtype == kF32 || res_dtype == kF32 || gy_dtype == kF32;",
         "    const bool wide = true;")],
    "backward: partial-row sum not chained": [("  config.numAttrs = 1;", "  config.numAttrs = 0;")],
    "as built, again": [],
}


def ptxas_notes(log: str) -> dict:
    """ptxas's registers of the path's instantiations (3 chunks a lane, and
    the partial-row sum), and any warning or spill, from ``-Xptxas -v``."""
    notes, entry = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and ("ILi3E" in entry or "sum_partials" in entry):
            notes[entry] = line.split("info    : ")[-1].strip()
        elif "arning" in line or ("spill" in line and " 0 bytes spill" not in line):
            notes.setdefault("warnings", []).append(line.strip())
    return notes


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("ln_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from aladin_torch.ops.kernels import build

    with open(os.path.join(build.CSRC_DIR, "layernorm_kernel.cu")) as f:
        source = f.read()
    with open(os.path.join(build.CSRC_DIR, "rowquant.cuh")) as f:  # inlined: variants edit it too
        source = source.replace('#include "rowquant.cuh"', f.read().replace("#pragma once", ""))
    out_dir = os.path.join(build.BUILD_DIR, "ln_variants")
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
        notes = ptxas_notes(log)
        lib = ctypes.CDLL(lib_path)
        lib.rln_q8_launch.argtypes = [p, i, p, i, p, p, p, p, p, i, i, ctypes.c_float, p]
        lib.rln_bwd_partial_rows.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.rln_bwd_launch.argtypes = [p, i, p, i, p, i, p, p, p, p, p, p, p, i, i, i, p]
        libs[name] = (lib, notes)

    gen = torch.Generator(device="cuda").manual_seed(8)
    d, eps = 768, 1e-12
    gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(d, generator=gen, device="cuda")

    def rows(m, scale=1.0):
        return (scale * torch.randn(m, d, generator=gen, device="cuda")).to(torch.bfloat16)

    q8_inputs = {m: (rows(m), rows(m, 0.5)) for m in (2688, 1600)}
    bwd_inputs = {}
    for m in (10752, 6400):
        x, res, gy = rows(m), rows(m, 0.5), rows(m)
        h = x.float() + res.float()
        mean = h.mean(1)
        rstd = torch.rsqrt(torch.clamp((h * h).mean(1) - mean * mean, min=0.0) + eps)
        bwd_inputs[m] = (x, res, gy, mean, rstd)
    want = {}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for name, (lib, notes) in libs.items():
        row = {"variant": name, "nvcc_notes": notes, "ms": {}, "equal_to_as_built": True}
        for m, (x, res) in q8_inputs.items():
            y = torch.empty_like(x)
            q = torch.empty(m, d, dtype=torch.int8, device="cuda")
            s = torch.empty(m, dtype=torch.float32, device="cuda")

            def k3b(lib=lib, x=x, res=res, y=y, q=q, s=s, m=m):
                err = lib.rln_q8_launch(x.data_ptr(), 0, res.data_ptr(), 0, gamma.data_ptr(),
                                        beta.data_ptr(), y.data_ptr(), q.data_ptr(), s.data_ptr(),
                                        m, d, eps, stream())
                if err:
                    raise RuntimeError(f"variant {name!r}: K3b launch failed ({err})")

            row["ms"][f"k3b M{m}"] = chip_smoke.device_ms(k3b, 50)
            got = (y.clone(), q.clone(), s.clone())
            key = f"k3b M{m}"
            if name == "as built":
                want[key] = got
            row["equal_to_as_built"] &= all(torch.equal(g, w) for g, w in zip(got, want[key]))
        for m, (x, res, gy, mean, rstd) in bwd_inputs.items():
            parts = ctypes.c_int(0)
            if lib.rln_bwd_partial_rows(m, d, 0, ctypes.byref(parts)):
                raise RuntimeError(f"variant {name!r}: rln_bwd_partial_rows failed")
            dx = torch.empty_like(x)
            dgb = torch.empty(2 * d, dtype=torch.float32, device="cuda")
            partial = torch.empty(parts.value, 2 * d, dtype=torch.float32, device="cuda")

            def bwd(lib=lib, x=x, res=res, gy=gy, mean=mean, rstd=rstd, dx=dx, dgb=dgb,
                    partial=partial, m=m):
                err = lib.rln_bwd_launch(x.data_ptr(), 0, res.data_ptr(), 0, gy.data_ptr(), 0,
                                         gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                         dx.data_ptr(), None, dgb.data_ptr(), partial.data_ptr(),
                                         partial.shape[0], m, d, stream())
                if err:
                    raise RuntimeError(f"variant {name!r}: backward launch failed ({err})")

            key = f"backward M{m}"
            row["ms"][key] = chip_smoke.device_ms(bwd, 50)
            row["partial_rows " + key] = parts.value
            got = (dx.clone(), dgb.clone())
            if name == "as built":
                want[key] = got
            row["equal_to_as_built"] &= bool(torch.equal(got[0], want[key][0]) and (
                (got[1] - want[key][1]).abs().max() <= 1e-5 * want[key][1].abs().max()))
        chip_smoke.emit(row)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
