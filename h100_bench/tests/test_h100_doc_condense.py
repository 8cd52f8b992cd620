"""The document-condensing runner through ``harness.run_cell`` on the CPU
at tiny sizes, in float32: the same code paths as on the card (the
program's packed prefill and hybrid-cache decoder, the taps, the per-layer
check and the KDA states against the plain reference), correct, with each
check in the line; and its controls, which the check must tell from the
program."""

from __future__ import annotations

import time

import torch

from h100_bench.lib import harness
from h100_bench.tests import tiny

KIMI_LINEAR = dict(
    vocab_size=97, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
    num_hidden_layers=4, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, num_experts=4, router_experts=16, expert_offset=4,
    num_experts_per_token=4, kda_gate_rank=8, compute_dtype="float32",
    linear_attn_config={"full_attn_layers": [4], "kda_layers": [1, 2, 3], "head_dim": 16,
                        "num_heads": 4, "short_conv_kernel_size": 4})
CONDENSE = {"batch": 4, "document_tokens": {"lognormal_quantiles": {
    "median": 12, "sigma": 0.8, "min": 5, "max": 30}}, "instruction_tokens": 3,
    "special_ids_from": 90, "new_tokens": 5, "pool_batches": 2, "check_documents": 3}
SEED = 2 ** 32 + 31
CELL = "kimilinear.condense_doc64"


def test_condense_runner_is_correct_on_the_cpu():
    line = harness.run_cell(tiny.ROOT, CELL, SEED, 0.2, False, torch.device("cpu"),
                            time.perf_counter(), config_over=KIMI_LINEAR,
                            traffic_over=CONDENSE)[0]
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"layer_gap", "route_differs", "token_gap", "logprob_gap",
                                   "state_gap"}
    checks = {n: v["value"] for n, v in line["checks"].items()}
    # float32 program and reference on the same inputs: only summation order differs
    assert checks["layer_gap"] < 1e-5 and checks["token_gap"] < 1e-4
    assert checks["state_gap"] < 1e-5 and checks["route_differs"] == 0
    assert set(line["metrics"]) == {"setup_s", "caption_images_per_s"}
    assert line["attempted"] % 4 == 0 and line["failed"] == 0


def test_condense_controls_read_apart_from_the_program():
    """fp8 GEMMs move ``layer_gap`` and a bf16 KDA state moves
    ``state_gap``, each by orders of magnitude."""
    manifest = harness.load_manifest(tiny.ROOT)
    cell = harness.find_cell(manifest, CELL)
    c = dict(harness.load_json(harness.config_file(tiny.ROOT, manifest, cell["config"])),
             **KIMI_LINEAR)
    tr = dict(harness.load_json(harness.traffic_file(tiny.ROOT, cell["traffic"])), **CONDENSE)
    runner = harness.load_runner(tiny.ROOT, tr["runner"])
    work = runner.setup(harness.Context(seed=SEED, device=torch.device("cpu"), config=c,
                                        traffic=tr))
    work.unit()
    work.release()
    program = {n: v for n, v, _ in work.check()}
    controls = {k: {n: v for n, v, _ in r} for k, r in runner.control(work).items()}
    assert controls["fp8_gemms"]["layer_gap"] > 100 * max(program["layer_gap"], 1e-7)
    assert controls["bf16_state"]["state_gap"] > 100 * max(program["state_gap"], 1e-7)
