"""No module of the benchmark loads JAX or the JAX package, and the plain
references load nothing of the program: every module under h100_bench/
is imported in a fresh interpreter and the top-level names it pulled in
are compared whole."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from h100_bench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "aladin_tpu"}
BENCH = os.path.join(ROOT, "h100_bench")


def modules():
    out = []
    for base, _, files in os.walk(BENCH):
        if os.path.basename(base) in ("__pycache__", ".cache"):
            continue
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(base, f), ROOT))
    return sorted(out)


PROBE = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
before = set(sys.modules)
spec = importlib.util.spec_from_file_location("probe_target", sys.argv[2])
mod = importlib.util.module_from_spec(spec)
sys.modules["probe_target"] = mod
spec.loader.exec_module(mod)
print(json.dumps(sorted({m.split(".")[0] for m in set(sys.modules) - before})))
"""


def loaded_by(path: str):
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT, os.path.join(ROOT, path)],
                         capture_output=True, text=True, timeout=240, cwd=ROOT,
                         env=dict(os.environ, USE_FLAX="0", USE_JAX="0", USE_TF="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("path", [p for p in modules() if "/tests/" not in p])
def test_module_loads_no_jax(path):
    tops = loaded_by(path)
    assert not tops & FORBIDDEN, (path, sorted(tops & FORBIDDEN))
    if "/reference/" in path:
        assert "aladin_torch" not in tops, path


def test_runners_load_the_port_without_jax():
    """What a run loads: every runner's program modules, imported as the
    set-up imports them."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import aladin_torch.models.aladin, aladin_torch.train.step, aladin_torch.train.state\n"
            "import aladin_torch.tasks.decode_cache, aladin_torch.tasks.captioning\n"
            "import aladin_torch.ops.kernels.alignment_kernel, aladin_torch.eval.recall\n"
            "import aladin_torch.eval.search\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert not FORBIDDEN & set(eval(out.stdout.strip().splitlines()[-1]))
