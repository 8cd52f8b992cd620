"""The six recipes of aladin_torch/configs/ (copies of aladin_tpu/configs/,
each YAML with a JSON twin for machines without pyyaml): each loads
through the port's ``load_config`` equal to aladin_tpu's, YAML and JSON
alike, and ``cli/train --config`` takes it for one synthetic epoch on the
CPU. The two ``*-finetune`` recipes freeze the backbone (freeze-teran): its
weights come out of the epoch unchanged, and
``alad-matching-distill-finetune`` starts from ``--load-teacher-model``.
TensorBoard's writer is made unimportable, so no TensorFlow loads here.
"""

import argparse
import glob
import os
import sys

import pytest
import torch

from aladin_torch.cli import train as torch_train_cli
from aladin_torch.cli.common import _build_aladin, add_shared_flags, to_data_args
from aladin_torch.config import load_config
from aladin_torch.io.checkpoint import save_checkpoint
from aladin_torch.train.state import TrainState
from aladin_tpu.config import load_config as jax_load_config
from tests.test_torch_threads import _two_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(os.path.basename(p)[:-5] for p in glob.glob(
    os.path.join(ROOT, "aladin_tpu", "configs", "*.yaml")))
DIMS = ["--synthetic", "--device", "cpu", "--max_seq_length", "20", "--max_img_seq_length",
        "12", "--img_feature_dim", "32", "--num_workers", "1", "--log_step", "1",
        "--val_step", "0", "--num_epochs", "1", "--compute_dtype", "float32"]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def synthetic_args():
    """The data flags of DIMS' synthetic model (seeded weights)."""
    p = argparse.ArgumentParser()
    add_shared_flags(p)
    return to_data_args(p.parse_args(["--synthetic", "--img_feature_dim", "32"]))


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A checkpoint of the flagship recipe's synthetic model with another
    seed than the student's, as cli/train writes it."""
    work = str(tmp_path_factory.mktemp("teacher"))
    cfg = load_config(os.path.join(ROOT, "aladin_torch", "configs",
                                   "alad-alignment-and-matching-distill.json"))
    args = synthetic_args()
    args.seed = 7
    model = _build_aladin(cfg, args)
    return save_checkpoint(work, TrainState(cfg, model), 1, cfg.to_dict(), 0.0)


def test_six_recipes_are_shipped():
    assert len(NAMES) == 6
    for name in NAMES:
        for ext in ("yaml", "json"):
            assert os.path.exists(os.path.join(ROOT, "aladin_torch", "configs",
                                               f"{name}.{ext}")), (name, ext)


@pytest.mark.parametrize("name", NAMES)
def test_recipe_loads_like_jax_and_trains(name, tmp_path, request):
    base = os.path.join(ROOT, "aladin_torch", "configs", name)
    want = jax_load_config(os.path.join(ROOT, "aladin_tpu", "configs", f"{name}.yaml")).to_dict()
    assert load_config(base + ".yaml").to_dict() == want
    assert load_config(base + ".json").to_dict() == want
    cfg = load_config(base + ".json")

    extra = []
    if name == "alad-matching-distill-finetune":
        extra = ["--load-teacher-model", request.getfixturevalue("teacher")]
    run = str(tmp_path / "run")
    res = torch_train_cli.run(["--config", base + ".json", "--output_dir", run,
                               "--logger_name", run, *DIMS, *extra])
    state = res["state"]
    assert state.step > 0
    assert all(torch.isfinite(p).all() for p in state.trainable)
    assert os.path.exists(res["checkpoint"])
    backbone = {k: v for k, v in state.model.state_dict().items()
                if k.startswith("oscar_model.")}
    if cfg.model.freeze_teran:
        assert state.frozen and not any(p is q for p in state.frozen for q in state.trainable)
        # the backbone's weights leave the epoch as they entered it: the
        # teacher's, or the seeded synthetic initialisation
        if extra:
            start = torch.load(extra[1], map_location="cpu", weights_only=False)["model"]
            start = {k[len("img_txt_enc."):]: v for k, v in start.items()}
        else:
            start = _build_aladin(cfg, synthetic_args()).state_dict()
        for k, v in backbone.items():
            assert torch.equal(v, start[k]), k
    else:
        assert not state.frozen
