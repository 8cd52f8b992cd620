#!/usr/bin/env python3
"""How many device records torch.profiler loses at the start of a trace, on
one CUDA card, as a process takes more traces.

    python3 tools/profiler_record_loss.py [--out FILE]

Each trace covers one eager window of 8 flagship train steps at B 128
(``chip_smoke.py``'s ``train_graph`` configuration: VinVL-base width,
fused_attention and fused_layernorm, dropout 0, random weights and batches
from a seed), with no pad in front. Per trace it prints the K2 / K3a kernel
counts (192 / 192 / 384 / 384 expected), the device kernel records against
the host's launch records, and the position of the first K2 forward in the
trace: a prefix lost at the start of the trace shows as fewer kernel records
and an earlier first K2. The traces run in segments, with other work between
them: 6 traces; ``chip_smoke.py``'s ``tensor_parallel`` phase; 6; two child
processes that each profile one step on the card at once; 6;
``train_levers``; 4. (``chip_smoke.py::device_profile`` pads its traces
against this loss.) Prints a line a trace, then the card's name, power
limit and driver; ``--out`` also writes every trace's record as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def window_setup(b: int = 128):
    """(model, state, step, window): 8 eager flagship steps at batch ``b``."""
    import torch

    import chip_smoke as cs
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_train_step

    cfg, model = cs.flagship_train_model(True, 0.0)
    state = TrainState(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, cfg, torch.bfloat16)
    batches = [cs.synth_train_batch(b, seed=10 + i) for i in range(cs.GRAPH_K)]

    def window():
        for x in batches:
            step(state, x, 0)
    return model, state, step, window


def traced(fn) -> dict:
    """One unpadded trace of ``fn``: the step kernels' counts, the device
    kernel records, the host's launch records, the first 12 device records'
    names and the first three K2 forwards' positions."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = sorted(((e.time_range.start, e.name) for e in events
                  if e.device_type == DeviceType.CUDA), key=lambda r: r[0])
    launches = {}
    for e in events:
        if e.device_type == DeviceType.CPU and "Launch" in e.name:
            launches[e.name] = launches.get(e.name, 0) + 1
    return {"counts": {k: sum(1 for _, n in dev if pat in n)
                       for k, pat in cs.STEP_KERNELS.items()},
            "kernel_records": sum(1 for _, n in dev if "Memcpy" not in n and "Memset" not in n),
            "launch_records": sum(launches.values()), "launch_records_by_name": launches,
            "first_names": [n[:60] for _, n in dev[:12]],
            "first_k2_fwd_positions": [i for i, (_, n) in enumerate(dev) if "attn_fwd" in n][:3]}


def segment(rec: dict, name: str, n: int) -> None:
    import chip_smoke as cs

    cs.fresh_memory()
    model, state, step, window = window_setup()
    window()
    rows = []
    for i in range(n):
        r = traced(window)
        rows.append(r)
        print(json.dumps({"segment": name, "trace": i, "counts": r["counts"],
                          "kernel_records": r["kernel_records"],
                          "launch_records": r["launch_records"],
                          "first_k2_fwd_positions": r["first_k2_fwd_positions"]}), flush=True)
    rec[name] = rows
    del model, state, step, window
    cs.fresh_memory()


def child() -> int:
    """One profiled flagship step at B 128 (``--child``)."""
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    _, state, step, _ = window_setup()
    batch = cs.synth_train_batch(128, seed=21)
    step(state, batch, 0)
    print(json.dumps({"child_device_ms": cs.device_profile(
        lambda: step(state, batch, 0), 1, top=0)["device_ms"]}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write every trace's record here as JSON")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("profiler_record_loss.py needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cs.phase_build()
    rec = {}
    segment(rec, "start", 6)
    with tempfile.TemporaryDirectory() as tmp:
        cs.phase_tensor_parallel(tmp)
    segment(rec, "after_tensor_parallel", 6)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"a profiling child failed: {[log[-2000:] for log in logs]}")
    segment(rec, "after_two_profiling_children", 6)
    cs.phase_train_levers()
    segment(rec, "end", 4)
    rec["seconds"] = time.perf_counter() - t0
    rec["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)
    print(rec["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(child() if sys.argv[1:] == ["--child"] else main())
