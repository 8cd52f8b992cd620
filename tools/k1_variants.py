#!/usr/bin/env python3
"""Time source variants of the MrSw kernel (K1, csrc/mrsw_kernel.cu) on one
CUDA card, at the 5k x 25k benchmark shape (S_im 34, S_s 50, D 768).

    python3 tools/k1_variants.py

Each variant is the kernel source with one design constant changed (ring
depth, band of image pairs, how many chunks of wgmma a consumer keeps in
flight). All are built with nvcc in parallel, run on the same prepared
operands, checked bit for bit against the unchanged kernel, and timed with
CUDA events (mean of 2 launches after one warm-up). The unchanged kernel
runs first and last, so the two give the run's spread. Prints one JSON line
per (dtype, variant), then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "as built": [],
    "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "band 2": [("constexpr int kBand = 4;", "constexpr int kBand = 2;")],
    "band 8": [("constexpr int kBand = 4;", "constexpr int kBand = 8;")],
    "band 16": [("constexpr int kBand = 4;", "constexpr int kBand = 16;")],
    "one chunk in flight (both types)": [
        ("constexpr bool kOverlap = sizeof(T) == 2;", "constexpr bool kOverlap = true;")],
    "no chunk in flight (both types)": [
        ("constexpr bool kOverlap = sizeof(T) == 2;", "constexpr bool kOverlap = false;")],
    "as built, again": [],
}


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("k1_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from aladin_torch.ops.kernels import alignment_kernel as ak
    from aladin_torch.ops.kernels import build

    with open(os.path.join(build.CSRC_DIR, "mrsw_kernel.cu")) as f:
        source = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "k1_variants")
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
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", path[:-3] + ".so", path]
        jobs[name] = (path[:-3] + ".so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib_path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        lib = ctypes.CDLL(lib_path)
        lib.mrsw_scores_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    bench = chip_smoke.corpus(gen, 5000, 25000, 34, 50)
    for dname, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        im, cap, _ = ak._prepare(*bench, dtype)
        a, b = ak._kernel_operands(im, cap)
        n_im, r, _ = im.shape
        n_cap, w, _ = cap.shape
        want = None
        for name, lib in libs.items():
            out = torch.empty(n_im, n_cap, device="cuda")

            def run(lib=lib, out=out):
                err = lib.mrsw_scores_launch(ak._DTYPE_CODE[dtype], a.data_ptr(), b.data_ptr(),
                                             out.data_ptr(), n_im, r, n_cap, w, a.shape[1],
                                             torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name!r} failed to launch: {err}")

            ms = chip_smoke.cuda_ms(run, 2)
            want = out.clone() if want is None else want
            chip_smoke.emit({"dtype": dname, "variant": name, "ms": ms,
                             "equal_to_as_built": bool(torch.equal(out, want))})
        del im, cap, a, b
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
