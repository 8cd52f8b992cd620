"""Data-pipeline smoke / throughput tool (mirrors aladin_tpu/cli/data_smoke.py).

The counterpart of the reference's standalone dataset main()
(ref:alad/dataset.py:381-554: iterate the full train loader doing nothing).
Reports samples/s of the host pipeline (tensorize + collate + prefetch +
the copy to ``--device``), through the native C++ TSV reader and through
the pure-Python one, with 1 and ``--num_workers`` loader threads, so IO
regressions are visible:

    python -m aladin_torch.cli.data_smoke --synthetic --device cpu   # quick check
    python -m aladin_torch.cli.data_smoke --data_dir ... --img_feat_file ...

``run(argv)`` returns one row a (reader, threads) pair: {"mode", "threads",
"samples", "seconds", "samples_per_s"}; ``main`` prints them and returns 0.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

from aladin_torch.cli.common import (add_shared_flags, build_tokenizer, prepare_synthetic,
                                     to_data_args)
from aladin_torch.data.dataset import RetrievalDataset
from aladin_torch.data.pipeline import BatchLoader
from aladin_torch.utils.device import resolve_device


def _parse(argv) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="data pipeline smoke (PyTorch)")
    add_shared_flags(parser)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=32)
    return parser.parse_args(argv)


def run(argv=None) -> List[Dict]:
    ns = _parse(argv)
    args = to_data_args(ns)
    device = resolve_device(ns.device)
    if args.synthetic:
        args = prepare_synthetic(args, n_images=64)

    tokenizer = build_tokenizer(args)
    rows = []
    for native in (True, False):
        ds = RetrievalDataset(tokenizer, args, "train", is_train=True, use_native_io=native)
        mode = "native" if ds.native_enabled else "python"
        # thread-pool scaling sweep: input-bound vs compute-bound is decided
        # by comparing the best samples/s here against the train-step rate
        for threads in sorted({1, args.num_workers}):
            loader = BatchLoader(ds, ns.batch_size, shuffle=True, num_threads=threads,
                                 device=device)
            n = 0
            t0 = time.perf_counter()
            for _ in range(ns.epochs):
                for batch in loader.epoch(0):
                    n += batch.txt_ids.shape[0]
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            rows.append({"mode": mode, "threads": threads, "samples": n, "seconds": dt,
                         "samples_per_s": n / dt})
    return rows


def main(argv=None) -> int:
    for r in run(argv):
        print(f"[{r['mode']} x{r['threads']} threads] {r['samples']} samples in "
              f"{r['seconds']:.2f}s -> {r['samples_per_s']:.0f} samples/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
