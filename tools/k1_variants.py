#!/usr/bin/env python3
"""Time source variants of the MrSw kernel (K1, csrc/mrsw_kernel.cu) on one
CUDA card, at the 5k x 25k benchmark shape (S_im 34, S_s 50, D 768).

    python3 tools/k1_variants.py [--lengths uniform|coco]

Each variant is the kernel source with one design constant changed (ring
depth, band of image pairs, how many chunks of wgmma a consumer keeps in
flight, the row stride of the epilogue's column maxima, the last region
slots through a 64-row slab in place of the 16-row tail pass). All are
built with nvcc in parallel, run on the same prepared operands (R 33 as
34 slots, the tail layout), checked against the unchanged kernel (bit for
bit, and the largest gap), and timed with CUDA events (mean of 2 launches
after one warm-up; the median of 5 rounds, each round every variant in
turn). The unchanged kernel runs first and last, so the two give the
run's spread. Beside them the unchanged kernel runs the same operands cut
to R 32 (no tail): the tail's cost as a share of the slab it replaces is
(as built - R 32) / (tail through a slab - R 32). Caption lengths:
uniform 4..50 tokens (``chip_smoke.corpus``), or ``coco``, round(9 +
Gamma(2, 2.5)) clipped to 8..50 as the score benchmark draws them. Prints
one JSON line per (dtype, variant) and the tail's cost a type, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "as built": [],
    "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "band 2": [("constexpr int kBand = 4;", "constexpr int kBand = 2;")],
    "band 8": [("constexpr int kBand = 4;", "constexpr int kBand = 8;")],
    "band 16": [("constexpr int kBand = 4;", "constexpr int kBand = 16;")],
    "column stride 256": [("constexpr int kColStride = kTileCols + 8;",
                           "constexpr int kColStride = kTileCols;")],
    "one chunk in flight (both types)": [
        ("constexpr bool kOverlap = sizeof(T) == 2;", "constexpr bool kOverlap = true;")],
    "no chunk in flight (both types)": [
        ("constexpr bool kOverlap = sizeof(T) == 2;", "constexpr bool kOverlap = false;")],
    "tail through a slab": [("constexpr bool kTailPass = true;",
                             "constexpr bool kTailPass = false;")],
    "as built, again": [],
}
REGIONS_32 = "as built, R 32 (no tail)"
ROUNDS = 5


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lengths", choices=("uniform", "coco"), default="uniform")
    lengths = p.parse_args().lengths
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
        lib.mrsw_scores_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 5 + [ctypes.c_long, ctypes.c_int]
                                           + [ctypes.c_void_p])
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    bench = chip_smoke.corpus(gen, 5000, 25000, 34, 50)
    if lengths == "coco":
        tokens = 9 + np.random.RandomState(0).gamma(2.0, 2.5, 25000)
        bench = (*bench[:3], torch.as_tensor(np.clip(np.round(tokens), 8, 50), device="cuda").long())
    for dname, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        im, words, _, plan, table = ak._packed(*bench, dtype)
        n_cap, n_tiles = len(plan.caps), len(plan.tiles)
        runs = {}  # name -> (launch, output)

        def launcher(lib, r, slots, a, b, out):
            def run():
                err = lib.mrsw_scores_launch(ak._DTYPE_CODE[dtype], a.data_ptr(), b.data_ptr(),
                                             table.data_ptr(), out.data_ptr(), len(im), r, slots,
                                             n_cap, n_tiles, b.shape[0], a.shape[1],
                                             torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"a K1 variant failed to launch: {err}")
            return run

        r = im.shape[1]
        slots = ak._group_slots(r)
        a, b = ak._kernel_operands(im, words)
        for name, lib in libs.items():
            out = torch.empty(len(im), n_cap, device="cuda")
            runs[name] = (launcher(lib, r, slots, a, b, out), out)
        # the floor of the tail's cost: the slabs alone, slot 32 left out
        a32, _ = ak._kernel_operands(im[:, :32].contiguous(), words)
        out = torch.empty(len(im), n_cap, device="cuda")
        runs[REGIONS_32] = (launcher(libs["as built"], 32, 32, a32, b, out), out)
        times = {name: [] for name in runs}
        for _ in range(ROUNDS):  # interleaved, so drift reaches every variant alike
            for name, (run, _) in runs.items():
                times[name].append(chip_smoke.cuda_ms(run, 2))
        want = runs["as built"][1]
        for name, (_, out) in runs.items():
            line = {"dtype": dname, "lengths": lengths, "variant": name,
                    "ms": sorted(times[name])[ROUNDS // 2], "ms_rounds": times[name]}
            if name != REGIONS_32:  # other scores: nothing to compare
                line.update(slots=slots, equal_to_as_built=bool(torch.equal(out, want)),
                            max_gap_to_as_built=float((out - want).abs().max()))
            chip_smoke.emit(line)
        tail, slab, floor = (sorted(times[n])[ROUNDS // 2] for n in
                             ("as built", "tail through a slab", REGIONS_32))
        chip_smoke.emit({"dtype": dname, "lengths": lengths,
                         "tail_cost_of_a_slab": (tail - floor) / (slab - floor)})
        del im, words, a, b, a32, table, runs
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
