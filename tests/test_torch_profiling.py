"""The port's profiling module against aladin_tpu's on the CPU: the train
step's FLOPs accounting (the same pure functions, equal values), and
``cli/train --profile_dir`` writing a torch.profiler trace.
"""

import json
import os
import sys

import pytest
import torch

from aladin_tpu.utils.profiling import train_step_model_flops as jax_step_flops
from aladin_tpu.utils.profiling import transformer_layer_flops as jax_layer_flops
from aladin_torch.cli import train as torch_train_cli
from aladin_torch.utils import profiling
from aladin_torch.utils.profiling import train_step_model_flops, transformer_layer_flops
from tests.test_torch_threads import _two_threads  # noqa: F401 (autouse)

CLI = ["--config", os.path.join(os.path.dirname(os.path.dirname(__file__)), "aladin_torch",
                                "configs", "alad-alignment-and-matching-distill.json"),
       "--synthetic", "--device", "cpu", "--max_seq_length", "20", "--max_img_seq_length", "12",
       "--img_feature_dim", "32", "--num_workers", "1", "--log_step", "1", "--val_step", "0"]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """cli/train's Trainer writes TensorBoard scalars on rank 0; with the
    writer unimportable it takes the no-op writer, and this test process
    imports no TensorFlow (tests/test_torch_host_tools.py reads the tags)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)



def test_layer_flops_formula():
    # hand count at S=4, d=2, ff=8: qkv+out 8*4*4=128, attn 4*16*2=128, ffn 4*4*2*8=256
    assert transformer_layer_flops(4, 2, 8) == 128 + 128 + 256
    for args in ((4, 2, 8), (50, 768, 3072), (84, 768, 3072), (84, 768, 768)):
        assert transformer_layer_flops(*args) == jax_layer_flops(*args)


def test_model_flops_scaling():
    f1 = train_step_model_flops(32)
    f2 = train_step_model_flops(64)
    # the encoder term is linear in B, the alignment term quadratic
    assert 2.0 < f2 / f1 < 4.0
    per_sample = train_step_model_flops(512) / 512
    assert 60e9 < per_sample < 110e9, per_sample
    for b in (1, 32, 128, 512):
        assert train_step_model_flops(b) == jax_step_flops(b)
    small = dict(text_len=12, img_text_len=12, n_regions=5, hidden=32, n_layers=2,
                 intermediate=64, img_feature_dim=16, tern_layers=1)
    for alignment in (True, False):
        assert (train_step_model_flops(8, alignment=alignment, **small)
                == jax_step_flops(8, alignment=alignment, **small))
    assert profiling.H100_SXM_BF16_DENSE_PEAK == 989e12


@pytest.mark.parametrize("k", ["1", "3"])
def test_train_cli_profile_dir_writes_a_trace(tmp_path, caplog, k):
    """--profile_dir on the CPU: one trace over two epochs (here of the
    first epoch's one dispatch), a Chrome trace that names the backbone's
    ops and holds the loop's spans, the traced counters logged beside its
    path; the run's result is the run's without it."""
    prof = str(tmp_path / "prof")
    with caplog.at_level("INFO", logger="vlpretrain"):
        out = torch_train_cli.run(CLI + ["--output_dir", str(tmp_path), "--logger_name",
                                         str(tmp_path / "run"), "--num_epochs", "2",
                                         "--profile_dir", prof, "--profile_steps", "2",
                                         "--steps_per_dispatch", k])
    assert out["trainer"].profiled
    assert sum("profiler trace" in r.getMessage() for r in caplog.records) == 1
    assert sum("traced counters" in r.getMessage() for r in caplog.records) == 1
    assert os.listdir(prof) == ["trace.json"]
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("addmm" in n or "linear" in n for n in names)
    assert any("backward" in n.lower() for n in names)
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"loop.data", "loop.dispatch"} <= spans, spans
    plain = torch_train_cli.run(CLI + ["--output_dir", str(tmp_path / "plain"),
                                       "--logger_name", str(tmp_path / "plain_run"),
                                       "--num_epochs", "2", "--steps_per_dispatch", k])
    assert plain["trainer"].best_rsum == out["trainer"].best_rsum
    assert plain["state"].step == out["state"].step
