"""The serving slice as a whole: aladin_tpu.cli.test and aladin_torch.cli.test
on one released-format checkpoint, on the CPU, plus the port's guards.

Both CLIs evaluate a ``.pth.tar`` written by aladin_tpu's
``save_aladin_checkpoint`` from seeded parameters, on the same synthetic
corpus, with f32 scoring. With f32 encoders (plain, ``--bucketed_encode``,
``--fivefold``) and with ``--int8_encoder``, both heads' R@1/5/10 and medr
must be equal and the alignment scores within 1e-4 (the same f32 math in
another summation order). With the default bf16 encoder the two packages
round differently inside the encoder, so the scores must agree within one
bf16 ulp at the largest score. Where an alignment rank differs, the scores
involved must be within the tolerance: a near-tie, not a fault.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import aladin_tpu.cli.test as jax_cli
from aladin_tpu.cli.common import build_tokenizer as jax_build_tokenizer
from aladin_tpu.cli.common import prepare_synthetic as jax_prepare_synthetic
from aladin_tpu.config import DataArgs as JaxDataArgs
from aladin_tpu.config import ExperimentConfig as JaxExperimentConfig
from aladin_tpu.data.dataset import RetrievalDataset as JaxRetrievalDataset
from aladin_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from aladin_tpu.io.convert import save_aladin_checkpoint
from aladin_tpu.models.aladin import ALADIN as JaxALADIN
from aladin_tpu.models.bert_img import BertImgConfig as JaxBertImgConfig
from aladin_torch.cli import search as torch_search
from aladin_torch.cli import test as torch_cli
from aladin_torch.eval.recall import ranks_from_score_matrix

TOL = 1e-4
DIMS = ["--max_seq_length", "20", "--max_img_seq_length", "12", "--img_feature_dim", "32"]
RECIPE = {"dataset": {"name": "coco"},
          "model": {"embed-size": 32, "tern-layers": 2, "teran-layers": 0, "dropout": 0.1},
          "training": {"loss-type": "alignment-distillation", "loss-weights": [1, 1], "bs": 8}}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A .pth.tar of seeded aladin_tpu parameters with the --synthetic
    backbone's shapes (vocab 512, 2 layers, 4 heads, FFN 2 x embed)."""
    work = str(tmp_path_factory.mktemp("slice"))
    args = jax_prepare_synthetic(JaxDataArgs(output_dir=os.path.join(work, "fixture"),
                                             max_seq_length=20, max_img_seq_length=12,
                                             img_feature_dim=32))
    ds = JaxRetrievalDataset(jax_build_tokenizer(args), args, "test", is_train=False)
    example = next(iter(JaxBatchLoader(ds, 8, shuffle=False, drop_last=False).epoch(0)))
    bert = JaxBertImgConfig(vocab_size=512, hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=64,
                            max_position_embeddings=128, img_feature_dim=32)
    model = JaxALADIN(JaxExperimentConfig.from_dict(RECIPE), bert)
    params = model.init(jax.random.PRNGKey(3), example, True)["params"]
    path = os.path.join(work, "model_best_rsum.pth.tar")
    save_aladin_checkpoint(path, jax.tree.map(np.asarray, params), RECIPE)
    return work, path


def _assert_ranks_or_near_tie(got, want, tol=TOL):
    """Equal alignment ranks, or a near-tie (< tol) behind every difference."""
    g_i2t, g_t2i = (r.numpy() for r in ranks_from_score_matrix(torch.from_numpy(got)))
    w_i2t, w_t2i = (r.numpy() for r in ranks_from_score_matrix(torch.from_numpy(want)))
    for scores, g, w in ((want, g_i2t, w_i2t), (want.T, g_t2i, w_t2i)):
        for q in np.nonzero(g != w)[0]:
            gaps = np.abs(scores[q][:, None] - scores[q][None, :])
            np.fill_diagonal(gaps, np.inf)
            assert gaps.min() < tol, (q, g[q], w[q])


def _both_clis(checkpoint, monkeypatch, tag, flags=()):
    """(the port's results, what aladin_tpu's CLI computed) on one checkpoint."""
    work, path = checkpoint
    common = ["--synthetic", "--load_checkpoint", path, *DIMS, *flags]
    if "--compute_dtype" not in flags:
        common += ["--compute_dtype", "float32"]
    seen = {}

    def record(name, fn):
        def wrapped(*a, **kw):
            seen[name] = fn(*a, **kw)
            return seen[name]
        monkeypatch.setattr(jax_cli, name, wrapped)

    for name in ("compute_recall", "recall_1k_5fold", "evaluate_alignment_head",
                 "fivefold_from_scores"):
        record(name, getattr(jax_cli, name))
    jout = os.path.join(work, "jax" + tag)
    assert jax_cli.main(common + ["--output_dir", jout, "--logger_name", jout,
                                  "--mesh_shape", "dp=1"]) == 0
    tout = os.path.join(work, "torch" + tag)
    got = torch_cli.run(common + ["--output_dir", tout, "--logger_name", tout,
                                  "--device", "cpu"])
    return got, seen


def _assert_same_results(got, seen, tol=TOL):
    """Scores within ``tol`` (absolute) and ranks equal up to near-ties;
    at the f32 tolerance both heads' R@K and medr equal too (at a bf16
    tolerance a near-tie flip may move them)."""
    want_i2t, want_t2i, want_scores = seen["evaluate_alignment_head"]
    if "fivefold_from_scores" in seen:
        want_i2t, want_t2i = seen["fivefold_from_scores"]
    want_scores = np.array(want_scores)
    assert got["scores"].shape == want_scores.shape == (8, 40)
    np.testing.assert_allclose(got["scores"], want_scores, atol=tol, rtol=0)
    _assert_ranks_or_near_tie(got["scores"], want_scores, tol)
    if tol > TOL:
        return
    for key in ("r1", "r5", "r10", "medr"):
        assert got["alignment_i2t"][key] == want_i2t[key], key
        assert got["alignment_t2i"][key] == want_t2i[key], key
    want_m = seen.get("recall_1k_5fold", seen.get("compute_recall"))
    for key in ("i2t_r1", "i2t_r5", "i2t_r10", "i2t_medr",
                "t2i_r1", "t2i_r5", "t2i_r10", "t2i_medr"):
        if key in want_m:  # the 5-fold dict has no medr
            assert got["matching"][key] == want_m[key], key


@pytest.mark.parametrize("flags", [[], ["--bucketed_encode"], ["--fivefold"],
                                   ["--compute_dtype", "bfloat16"]],
                         ids=["f32", "bucketed_encode", "fivefold", "bf16"])
def test_cli_slice_matches_jax(checkpoint, monkeypatch, flags):
    """f32 encoders within 1e-4; the default bf16 encoder within one bf16
    ulp (2^-7 relative) at the largest alignment score."""
    got, seen = _both_clis(checkpoint, monkeypatch, "_" + "_".join(flags), flags)
    tol = TOL
    if "bfloat16" in flags:
        tol = float(np.abs(np.asarray(seen["evaluate_alignment_head"][2])).max()) * 2.0 ** -7
    _assert_same_results(got, seen, tol)


def test_cli_int8_encoder_matches_jax(checkpoint, monkeypatch):
    """--int8_encoder in both CLIs: the W8A8 QKV and FFN-up GEMMs, f32 out.
    The port quantizes activations with the dynx kernel's reciprocal-multiply
    scale where aladin_tpu's CPU path divides, so a scale may differ by one
    f32 ulp; the same 1e-4 on the scores holds."""
    _assert_same_results(*_both_clis(checkpoint, monkeypatch, "_int8", ["--int8_encoder"]))


def test_cli_needs_cuda_unless_cpu_asked(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the guard under test cannot fire")
    work, path = checkpoint
    with pytest.raises(RuntimeError, match="--device cpu"):
        torch_cli.main(["--synthetic", "--load_checkpoint", path, *DIMS,
                        "--output_dir", os.path.join(work, "nocuda")])


@pytest.mark.parametrize("flags", [["--mesh_shape", "dp=1,tp=2"],
                                   ["query", "--mesh_shape", "dp=1,tp=2"]])
def test_cli_unported_flags_raise(flags):
    """cli/test and cli/search query on a dp=1,tp=2 mesh in a process without
    a process group: the mesh spans 2 ranks and the group has 1, so it
    raises and names the launch that gives it its ranks."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        if flags[0] == "query":
            torch_search.main([*flags, "--index_dir", "unused", "--query_index", "0",
                               "--device", "cpu"])
        else:
            torch_cli.main(["--synthetic", "--device", "cpu", *flags])


BLOCKER = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "orbax", "aladin_tpu"}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import aladin_torch
names = [m.name for m in pkgutil.walk_packages(aladin_torch.__path__, "aladin_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
assert not any(m.split(".")[0] in {"jax", "flax", "aladin_tpu", "nltk"} for m in sys.modules)
print(" ".join(names))
"""


def test_port_imports_no_jax():
    """Every aladin_torch module (and chip_smoke) imports with jax, flax,
    optax, orbax and aladin_tpu blocked, and without importing nltk (METEOR
    imports it at its first use)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", BLOCKER], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 20
    assert {"aladin_torch.eval.dcg", "aladin_torch.eval.rouge", "aladin_torch.eval.relevance",
            "aladin_torch.models.attention_aggregation", "aladin_torch.parallel",
            "aladin_torch.parallel.distributed", "aladin_torch.parallel.mesh",
            "aladin_torch.cli.pretrain", "aladin_torch.cli.classify",
            "aladin_torch.tasks.pretraining", "aladin_torch.tasks.pretrain_data",
            "aladin_torch.tasks.classification", "aladin_torch.tasks.task_inputs",
            "aladin_torch.tasks.captioning", "aladin_torch.eval.cider",
            "aladin_torch.eval.meteor", "aladin_torch.eval.spice",
            "aladin_torch.eval.caption_metrics", "aladin_torch.eval.nocaps",
            "aladin_torch.utils.metric_logger", "aladin_torch.tasks.decode_cache",
            "aladin_torch.tasks.cbs", "aladin_torch.tasks.scst",
            "aladin_torch.tasks.oscar_teacher", "aladin_torch.tasks.retrieval_oscar",
            "aladin_torch.cli.captioning", "aladin_torch.cli.retrieval_oscar",
            "aladin_torch.parallel.sharding", "aladin_torch.cli.parity",
            "aladin_torch.cli.data_smoke", "aladin_torch.ops.activations",
            "aladin_torch.models.kimi_vl", "aladin_torch.ops.moe",
            "aladin_torch.tasks.decode_latent"} <= names
