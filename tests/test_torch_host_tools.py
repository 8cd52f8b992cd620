"""The host-side tools of aladin_torch on the CPU: cli/data_smoke (the loader
throughput sweep of aladin_tpu/cli/data_smoke.py) and the Trainer's
TensorBoard scalars (aladin_tpu/train/loop.py's tags), read through a stub
writer over one synthetic epoch of cli/train."""

import json
import os
import sys
from collections import defaultdict

import pytest
import torch

from aladin_torch.cli import data_smoke
from aladin_torch.cli import train as torch_train_cli
from aladin_torch.train import loop as torch_loop
from tests.test_torch_threads import _two_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(ROOT, "aladin_torch", "configs", "alad-alignment-and-matching-distill.json")
DIMS = ["--synthetic", "--device", "cpu", "--max_seq_length", "20", "--max_img_seq_length",
        "12", "--img_feature_dim", "32"]


def test_data_smoke_sweeps_readers_and_threads(tmp_path, capsys):
    """Both readers (the native one when g++ built it) at 1 and
    --num_workers threads, every synthetic train sample each time, on the
    CPU; main prints one line a row."""
    rows = data_smoke.run([*DIMS, "--output_dir", str(tmp_path), "--num_workers", "2",
                           "--batch_size", "16"])
    from aladin_torch.io.native import available

    first = "native" if available() else "python"
    assert [(r["mode"], r["threads"]) for r in rows] == [(first, 1), (first, 2), ("python", 1),
                                                          ("python", 2)]
    for r in rows:
        assert r["samples"] == 320 and r["seconds"] > 0  # 64 images x 5 captions
        assert r["samples_per_s"] == pytest.approx(r["samples"] / r["seconds"])
    assert data_smoke.main([*DIMS, "--output_dir", str(tmp_path), "--num_workers", "1"]) == 0
    assert "samples/s" in capsys.readouterr().out


class StubWriter:
    def __init__(self):
        self.scalars = defaultdict(list)  # tag -> [(step, value)]
        self.flushed = False

    def add_scalar(self, tag, value, global_step=None):
        self.scalars[tag].append((global_step, float(value)))

    def flush(self):
        self.flushed = True

    def close(self):
        pass


def test_trainer_tensorboard_tags(tmp_path, monkeypatch):
    """One synthetic epoch (the flagship recipe at bs 8: 5 steps; log_step 2,
    so that a flush covers two steps) and its validation: aladin_tpu's tags, per step epoch / step /
    lr / every metric of the step, batch_time and data_time per flush, and
    matching/*, alignment/* and rsum at the step count of each validation."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    writers = []
    monkeypatch.setattr(torch_loop, "make_tb_writer",
                        lambda log_dir: writers.append(StubWriter()) or writers[-1])
    recipe = json.load(open(RECIPE))
    recipe["training"]["bs"] = 8
    with open(tmp_path / "recipe.json", "w") as f:
        json.dump(recipe, f)
    run = str(tmp_path / "run")
    res = torch_train_cli.run(["--config", str(tmp_path / "recipe.json"), *DIMS,
                               "--output_dir", run, "--logger_name", run, "--num_workers", "1",
                               "--log_step", "2", "--val_step", "0", "--num_epochs", "1"])
    (tb,) = writers
    steps = res["state"].step
    assert steps == 5 and tb.flushed
    metrics = {"loss", "alignment_loss", "distillation_loss", "grad_norm"}
    per_step = {"epoch", "step", "lr"} | metrics
    validation = ({f"matching/{k}" for k in ("r1", "r5", "r10", "r1i", "r5i", "r10i", "rsum")}
                  | {f"alignment/{k}" for k in ("r1", "r5", "r10", "r1i", "r5i", "r10i", "medr",
                                                "meanr", "ndcg_rougel", "ndcg_spice")}
                  | {"rsum"})
    assert set(tb.scalars) == per_step | {"batch_time", "data_time"} | validation
    for tag in per_step:
        assert [s for s, _ in tb.scalars[tag]] == [1, 2, 3, 4, 5], tag
    assert [v for _, v in tb.scalars["step"]] == [0, 1, 2, 3, 4]
    assert [v for _, v in tb.scalars["epoch"]] == [0] * 5
    sched = res["state"].schedule
    assert [v for _, v in tb.scalars["lr"]] == pytest.approx([sched(i) for i in range(5)])
    assert [s for s, _ in tb.scalars["batch_time"]] == [2, 4, 5]  # one a flush
    for tag in validation:
        assert [s for s, _ in tb.scalars[tag]] == [steps], tag
    trainer = res["trainer"]
    assert tb.scalars["matching/rsum"][0][1] + tb.scalars["rsum"][0][1] == pytest.approx(
        trainer.best_rsum)
