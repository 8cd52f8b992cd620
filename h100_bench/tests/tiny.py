"""Tiny sizes of each cell for the CPU tests: the same code paths at a
few rows and a narrow width, in float32 so that the program and the
reference agree to rounding."""

from __future__ import annotations

import os
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BACKBONE = {"vocab_size": 1200, "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "intermediate_size": 128, "max_position_embeddings": 64,
            "img_feature_dim": 16}
SETS = {"images": 12, "captions_per_image": 5, "region_slots": 6, "word_slots": 10,
        "regions": {"uniform": [3, 6]}, "caption_tokens": {"uniform": [4, 10]}}

CELLS = {
    "aladin.train_bs32": (
        dict(BACKBONE, max_seq_length=12, max_img_seq_length=6, tern_dim_feedforward=64, bs=4,
             steps_per_dispatch=2, compute_dtype="float32"),
        {"caption_tokens": {"uniform": [4, 12]}, "label_tokens": {"uniform": [4, 12]},
         "regions": {"uniform": [3, 6]}, "pool_windows": 2}),
    "caption.greedy_kv512": (
        dict(BACKBONE, max_seq_a_length=8, max_seq_length=12, max_img_seq_length=6),
        {"batch": 3, "label_tokens": {"uniform": [2, 4]}, "regions": {"uniform": [3, 6]},
         "pool_batches": 2, "check_captions": 4}),
    "aladin.score_5k": (dict(BACKBONE), dict(SETS, check_rows=4)),
    "aladin.t2i_search": (dict(BACKBONE),
                          dict(SETS, images=40, k=5, shortlist=10, warmup_queries=2,
                               check_queries=4)),
}


def run(cell: str, seed: int = 2 ** 32 + 17, seconds: float = 0.2, root: str = ROOT) -> dict:
    """One run of ``cell`` on the CPU at its tiny size."""
    from h100_bench.lib import harness

    config_over, traffic_over = CELLS[cell]
    return harness.run_cell(root, cell, seed, seconds, False, torch.device("cpu"),
                            time.perf_counter(), config_over=config_over,
                            traffic_over=traffic_over)[0]
