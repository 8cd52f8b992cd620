"""tools/k2_variants.py on the CPU: every variant's edit finds its text in
csrc/attention_kernel.cu exactly once (a kernel edit that moves a line
breaks the tool here, not on the card), and the tool refuses to run
without a CUDA device."""

import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "k2_variants", os.path.join(ROOT, "tools", "k2_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_variant_edit_matches_the_source_once():
    with open(os.path.join(ROOT, "aladin_torch", "csrc", "attention_kernel.cu")) as f:
        source = f.read()
    variants = _tool().VARIANTS
    assert variants["as built"] == [] and variants["as built, again"] == []
    for name, edits in variants.items():
        for old, new in edits:
            assert source.count(old) == 1, (name, old)
            assert old != new, name


def test_tool_needs_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without a CUDA device")
    assert _tool().main() == 2
