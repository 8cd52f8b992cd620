#!/usr/bin/env python3
"""Time source variants of the fused attention kernels (K2,
csrc/attention_kernel.cu) on one CUDA card, at the paths' shapes: the
captioning step's B 32 and the decoder's B 16 at S 120 under per-row 2-D
block masks (tasks/captioning.py::_decode_attention_mask, bias_q == S), and
the training path's B 128 at S 84 and 50 under a 1-D key mask; 12 heads of
64, bf16, dropout 0.1 (the seed on the card) and 0.

    python3 tools/k2_variants.py [--baseline PATH]

Each variant is the kernel source with one line changed: the forward's
launch plan (``plan_fwd``: heads a block, query-row parts, q / k / v sets,
warp groups) forced to one cut, the order of its first syncs and loads,
the backward's heads a block, or the softmax's quotient. Design variants
are checked bit for bit against the unchanged source (ctx, dq, dk, dv at
every shape and rate, and at the ragged S 17, 121 and 160 under 2-D
masks); "diagnostic" variants leave out one part of
the work (staging the 2-D bias, the softmax) to show what it costs, and
are not checked. ``--baseline PATH`` adds a whole other source of the same
C interface (an earlier commit's attention_kernel.cu, unpacked with ``git
archive``), checked and timed like a variant. The unchanged source is also
held to the plain versions (one bf16 ulp of the largest output). All are
built with nvcc in parallel and timed as chip_smoke.py times the kernels
(card time of calls queued behind a spin kernel, 50 calls); the unchanged
source runs first and last, so the two give the run's spread. Prints one
JSON line per variant, one of the library's times at the same inputs
(F.scaled_dot_product_attention with the bias as a bf16 mask at rate 0,
and autograd.grad through it), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUARDS = ("  while (p.groups > 1 && p.groups * part_warps(nw, p.parts) > max_warps) --p.groups;\n"
          "  p.buffers = p.heads > p.groups ? 2 : 1;")


def forced(heads: int, parts: int, buffers: int, groups: int):
    """The 2-D plan forced to (heads, parts, buffers, groups), where it fits
    (plan_fwd's guards: fewer groups within the launch bound, then one set
    and one group within the shared memory); the 1-D path kept."""
    return [(GUARDS, f"  p = {{{heads}, {parts}, {buffers}, {groups}}};\n" + GUARDS.split("\n")[0])]


QUOTIENT = ("      const float q0 = __fmul_rn(s[j][e], inv[e >> 1]);\n"
            "      s[j][e] = __fmaf_rn(__fmaf_rn(-sum[e >> 1], q0, s[j][e]), inv[e >> 1], q0);")
VARIANTS = {
    "as built": [],
    "2-D plan {1 head, 1 part, 1 set, 1 group}: one block a head, the bias staged":
        forced(1, 1, 1, 1),
    "2-D plan {3, 1, 2, 1}: one group, its next head's tiles loading": forced(3, 1, 2, 1),
    "2-D plan {3, 1, 1, 2}: two groups, one set each": forced(3, 1, 1, 2),
    "2-D plan {2, 1, 1, 2}: two groups, a head each": forced(2, 1, 1, 2),
    "2-D plan {1, 2, 1, 1}: a head's rows over two blocks": forced(1, 2, 1, 1),
    "2-D plan {3, 2, 1, 3}: three groups of half a head's rows": forced(3, 2, 1, 3),
    "2-D plan {4, 2, 1, 4}: four groups of half a head's rows": forced(4, 2, 1, 4),
    "2-D: the first heads' q, k and v synced over the block": [
        ("    sync();\n    if (ahead && n > 0) prefetch();",
         "    if (n == 0) __syncthreads(); else sync();\n    if (ahead && n > 0) prefetch();"),
        ("      sync();\n    }", "      if (n == 0) __syncthreads(); else sync();\n    }")],
    "2-D: the first prefetch issued with q and k landed": [
        ("    if (ahead && n > 0) prefetch();", "    if (ahead) prefetch();"),
        ("      cp_async_wait<1>();\n      __syncthreads();",
         "      if (ahead) cp_async_wait<2>(); else cp_async_wait<1>();\n      __syncthreads();"),
        ("    if (ahead && n == 0) prefetch();", "")],
    "backward: one block a head, the 2-D bias over the pd and ds tiles": [
        ("  const int heads = bias_q == 1 ? 1 : wave_heads(b, h, 1, sm_count());",
         "  const int heads = 1;")],
    "softmax: the IEEE divide for p = e / sum": [
        (QUOTIENT, "      s[j][e] = s[j][e] > 0.f ? s[j][e] / sum[e >> 1] : 0.f;")],
    "diagnostic: 2-D bias not staged": [
        ("  if constexpr (M2D) stage_bias_rows(bias_b, bs, s_len, SP, row0, nb);", ""),
        ("    if (M2D && (i == 0 || !own)) stage_bias_rows(bias_b, b2, s_len, SP, 0, SP);", "")],
    "diagnostic: forward without the softmax": [
        ("      softmax_rows<NT>(brow0, brow1, inv_sqrt_d, s);", "")],
    "as built, again": [],
}
H, D = 12, 64
TIMED = (("caption B32 S120 Q120", 32, 120, "caption"),
         ("decode B16 S120 Q120", 16, 120, "caption"),
         ("train B128 S84 Q1", 128, 84, "keys"), ("train B128 S50 Q1", 128, 50, "keys"))
CHECKED = (("B32 S17 Q17", 32, 17, "random"), ("B32 S121 Q121", 32, 121, "random"),
           ("B32 S160 Q160", 32, 160, "random"))


def build(sources: dict) -> dict:
    """{name: (ctypes library, ptxas lines)}: every source through nvcc at once."""
    from aladin_torch.ops.kernels import build as kb

    out_dir = os.path.join(kb.BUILD_DIR, "k2_variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o", path[:-3] + ".so", path]
        jobs[name] = (path[:-3] + ".so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    for name, (lib_path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        # registers and spills of the bf16 kernels at S_pad 128 (W / NW = 8)
        notes = [line.strip() for line in log.splitlines()
                 if "spill" in line.lower() and " 0 bytes spill" not in line]
        regs, kernel = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line
            elif "Used" in line and kernel and "bf16ILi8E" in kernel:
                what = ("bwd" if "bwd" in kernel else "fwd") + (" 2-D" if "Lb1E" in kernel else "")
                regs.append(f"{what}: " + line.split("ptxas info    : ")[-1])
        lib = ctypes.CDLL(lib_path)
        lib.attn_fwd_launch.argtypes = [i32, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32, p,
                                        u32, f32, f32, i32, p]
        lib.attn_bwd_launch.argtypes = [i32, p, p, p, p, p, p, p, p, i32, i32, i32, i32, i32, i32,
                                        i32, p, u32, f32, f32, i32, p]
        libs[name] = (lib, notes[:6] + regs)
    return libs


def inputs(gen, b: int, s: int, kind: str):
    """q, k, v, g (B, S, 12, 64) bf16 and the f32 bias of a mask kind:
    "caption" block masks as tasks/captioning.py builds them (40 + 30 + 50
    slots, OD and region lengths drawn a row, a padded OD label and region
    rows fully masked), "keys" a key-padding (B, 1, S) mask, "random" a 2-D
    mask with each entry kept at 0.8."""
    import numpy as np
    import torch

    from aladin_torch.tasks.captioning import _decode_attention_mask

    q, k, v, g = (torch.randn(b, s, H, D, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(4))
    if kind == "caption":
        rng = np.random.RandomState(b)
        keep = torch.from_numpy(np.stack([
            _decode_attention_mask(40, 70, 50, int(o), int(r))
            for o, r in zip(rng.randint(1, 31, b), rng.randint(10, 51, b))])).cuda() > 0
    elif kind == "keys":
        lens = torch.randint(4, s + 1, (b,), generator=gen, device="cuda")
        keep = (torch.arange(s, device="cuda")[None] < lens[:, None])[:, None, :]
    else:
        keep = torch.rand(b, s, s, generator=gen, device="cuda") > 0.2
    keep[0] = False  # a fully padded row stays finite (-10000, not -inf)
    return q, k, v, g, (~keep).float() * -10000.0


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("k2_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another attention_kernel.cu to check and time")
    args = ap.parse_args()
    import chip_smoke
    from aladin_torch.ops.kernels import attention_kernel as ak
    from aladin_torch.ops.kernels import build as kb

    with open(os.path.join(kb.CSRC_DIR, "attention_kernel.cu")) as f:
        source = f.read()
    sources = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        sources[name] = text
    if args.baseline:
        with open(args.baseline) as f:
            sources[f"baseline: {args.baseline}"] = f.read()
    libs = build(sources)

    gen = torch.Generator(device="cuda").manual_seed(15)
    cases = [(tag, True, inputs(gen, b, s, kind)) for tag, b, s, kind in TIMED]
    cases += [(tag, False, inputs(gen, b, s, kind)) for tag, b, s, kind in CHECKED]
    seed = torch.full((), 7, dtype=torch.int64, device="cuda")
    want, worst = {}, 0.0
    for name, (lib, notes) in libs.items():
        row = {"variant": name, "ptxas": notes, "ms": {}}
        check = not name.startswith("diagnostic") and name != "as built"
        if check:
            row["equal_to_as_built"] = True
        for tag, timed, (q, k, v, g, bias) in cases:
            outs = {}
            for rate in (0.1, 0.0):
                ctx, grads = torch.empty_like(q), [torch.empty_like(q) for _ in range(3)]

                def fwd(lib=lib, q=q, k=k, v=v, bias=bias, ctx=ctx, rate=rate):
                    err = lib.attn_fwd_launch(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              bias.data_ptr(), ctx.data_ptr(), *ak._launch_args(
                                                  q, bias, seed, rate, True, H, 0,
                                                  torch.cuda.current_stream().cuda_stream))
                    if err:
                        raise RuntimeError(f"variant {name!r}: forward launch failed ({err})")

                def bwd(lib=lib, q=q, k=k, v=v, bias=bias, g=g, grads=grads, rate=rate):
                    err = lib.attn_bwd_launch(0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              bias.data_ptr(), g.data_ptr(),
                                              *(t.data_ptr() for t in grads), *ak._launch_args(
                                                  q, bias, seed, rate, True, H, 0,
                                                  torch.cuda.current_stream().cuda_stream))
                    if err:
                        raise RuntimeError(f"variant {name!r}: backward launch failed ({err})")

                fwd()
                bwd()
                torch.cuda.synchronize()
                outs[rate] = [ctx.clone()] + [t.clone() for t in grads]
                if timed:
                    row["ms"][f"{tag} fwd rate{rate}"] = chip_smoke.device_ms(fwd, 50)
                    row["ms"][f"{tag} bwd rate{rate}"] = chip_smoke.device_ms(bwd, 50)
                if name == "as built":
                    plain = [ak.attention_forward_plain(q, k, v, bias, seed, rate, True),
                             *ak.attention_backward_plain(q, k, v, bias, g, seed, rate, True)]
                    for got, ref in zip(outs[rate], plain):
                        err = (got.float() - ref.float()).abs().max().item()
                        tol = chip_smoke.BF16_ULP * ref.float().abs().max().item()
                        worst = max(worst, err / tol)
                        if not (err <= tol and torch.isfinite(got).all()):
                            raise AssertionError(f"{tag} rate {rate}: the kernel is {err} from "
                                                 f"its plain version (tolerance {tol})")
            if name == "as built":
                want[tag] = outs
            elif check:
                row["equal_to_as_built"] &= all(
                    torch.equal(a, w) for rate in outs for a, w in zip(outs[rate], want[tag][rate]))
        if name == "as built":
            row["plain_err_over_tolerance"] = worst
        chip_smoke.emit(row)
    # the library yardstick at the same inputs: SDPA with the bias as a bf16
    # mask at rate 0, and autograd.grad through it
    import torch.nn.functional as F

    row = {"variant": "library: F.scaled_dot_product_attention (rate 0)", "ms": {}}
    for tag, timed, (q, k, v, g, bias) in cases:
        if not timed:
            continue
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        mask = bias[:, None].to(torch.bfloat16)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        gt = g.transpose(1, 2)

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask):
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        row["ms"][f"{tag} fwd rate0.0"] = chip_smoke.device_ms(sdpa, 50)
        row["ms"][f"{tag} bwd rate0.0"] = chip_smoke.device_ms(
            lambda out=out, qt=qt, kt=kt, vt=vt, gt=gt: torch.autograd.grad(
                out, (qt, kt, vt), gt, retain_graph=True), 50)
    chip_smoke.emit(row)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
