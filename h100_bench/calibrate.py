"""Readings that the check's limits are set from, on the card: for each
seed, the numbers the check compares for a sound run of the program (a
short window at the cell's own load) and for the cell's control (and, in
training, a planted fault), all in one process.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]

Prints one JSON line a seed and writes them to ``--out`` if given. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from h100_bench.run import cache_env

    cache_env(ROOT)
    import torch

    from h100_bench.lib import harness

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    manifest = harness.load_manifest(ROOT)
    cell = harness.find_cell(manifest, args.workload)
    config = harness.load_json(harness.config_file(ROOT, manifest, cell["config"]))
    traffic = harness.load_json(harness.traffic_file(ROOT, cell["traffic"]))
    runner = harness.load_runner(ROOT, traffic["runner"])
    device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(seed=seed, device=device, config=config, traffic=traffic)
        work = runner.setup(ctx)
        units = 0
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < args.seconds:
            work.unit()
            units += 1
        work.drain()
        failed = work.failed()
        work.release()
        torch.cuda.empty_cache()
        program = {n: v for n, v, _ in work.check()}
        controls = {name: {n: v for n, v, _ in readings}
                    for name, readings in runner.control(work).items()}
        del work
        torch.cuda.empty_cache()
        row = {"cell": args.workload, "seed": seed, "units": units, "failed": failed,
               "program": program, "controls": controls,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
