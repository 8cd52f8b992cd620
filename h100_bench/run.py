"""The port's benchmark: one run of one cell on the card.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
directory and the ``aladin_torch`` package. Set-up (imports, kernels built
or loaded from the checkout's caches, weights and inputs made on the card
from the seed, warm-up of the cell's shapes) is ``setup_s``; then the cell
runs its units for ``--seconds`` and the check compares what the window
produced with the plain reference. The last line of standard output is the
result as one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key.

With ``--trace 1`` the window (at most the traffic file's
``trace_seconds``) runs under the profiler and the line carries the cell's
per-layer metrics instead of its end-to-end ones.

Exits non-zero with no result when CUDA is not available or has fewer
devices than the cell asks for, and when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_env(root: str) -> None:
    """Fixed cache directories inside the checkout (the port's nvcc
    libraries already go to ``aladin_torch/_build/``), and no JAX backend
    for any library that would load one."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "h100_bench", ".cache", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from h100_bench.lib import harness, smi

    manifest = harness.load_manifest(ROOT)
    try:
        cell = harness.find_cell(manifest, args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line, notes = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda", 0), T_START,
                                   chips=cell["chips"])
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"modules the port must not load are in sys.modules: {loaded}", file=sys.stderr)
        return 4
    print(f"card: {smi.card_line()}", file=sys.stderr)
    print(f"window: {json.dumps(notes)}", file=sys.stderr)
    for name, c in line["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
