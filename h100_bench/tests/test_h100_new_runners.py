"""The re-captioning runner through ``harness.run_cell`` on the CPU at tiny
sizes, in float32: the same code paths as on the card (the program's
decoder, the taps, the per-layer check against the plain reference),
correct, with each check in the line; and its controls, which the check
must tell from the program."""

from __future__ import annotations

import time

import torch

from h100_bench.lib import harness
from h100_bench.tests import tiny

KIMI = dict(vocab_size=97, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
            kv_lora_rank=32, qk_rope_head_dim=8, v_head_dim=16, qk_nope_head_dim=16,
            num_experts_per_tok=2, media_placeholder_token_id=96, compute_dtype="float32")
RECAPTION = {"batch": 3, "image_tokens": {"choice": [[4, 0.5], [6, 0.5]]},
             "text_before_image": 2, "text_after_image": 3, "new_tokens": 5, "pool_batches": 2,
             "check_captions": 3}
SEED = 2 ** 32 + 29


def run(cell, config_over, traffic_over, root=tiny.ROOT):
    return harness.run_cell(root, cell, SEED, 0.2, False, torch.device("cpu"),
                            time.perf_counter(), config_over=config_over,
                            traffic_over=traffic_over)[0]


def test_recaption_runner_is_correct_on_the_cpu():
    line = run("kimivl.recaption_b256", KIMI, RECAPTION)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"layer_gap", "route_differs", "token_gap", "logprob_gap"}
    checks = {n: v["value"] for n, v in line["checks"].items()}
    # float32 program and reference on the same inputs: only summation order differs
    assert checks["layer_gap"] < 1e-5 and checks["token_gap"] < 1e-4
    assert checks["route_differs"] == 0
    assert set(line["metrics"]) == {"setup_s", "caption_images_per_s"}
    assert line["attempted"] % 3 == 0 and line["failed"] == 0


def test_recaption_controls_read_apart_from_the_program():
    """fp8 experts move ``layer_gap`` by orders of magnitude; a router that
    drops the correction bias moves ``route_differs`` off zero."""
    manifest = harness.load_manifest(tiny.ROOT)
    cell = harness.find_cell(manifest, "kimivl.recaption_b256")
    c = dict(harness.load_json(harness.config_file(tiny.ROOT, manifest, cell["config"])), **KIMI)
    tr = dict(harness.load_json(harness.traffic_file(tiny.ROOT, cell["traffic"])), **RECAPTION)
    runner = harness.load_runner(tiny.ROOT, tr["runner"])
    work = runner.setup(harness.Context(seed=SEED, device=torch.device("cpu"), config=c,
                                        traffic=tr))
    work.unit()
    work.release()
    program = {n: v for n, v, _ in work.check()}
    controls = {k: {n: v for n, v, _ in r} for k, r in runner.control(work).items()}
    assert controls["fp8_experts"]["layer_gap"] > 100 * max(program["layer_gap"], 1e-7)
    assert controls["router_without_bias"]["route_differs"] > 0
