"""Tensor parallelism in aladin_torch on a 4-rank gloo group on the CPU:
the (dp, tp) mesh (parallel/mesh.py), the Megatron sharding
(parallel/sharding.py: rules, shard_module_, full_state_dict, the
conjugate collectives), the tp-aware train step (train/step.py,
train/state.py), dropout under tp, the checkpoint of a tp run, and
cli/train / cli/test / cli/parity / cli/search under ``--mesh_shape
dp=2,tp=2``.

One cluster serves the module, as in tests/test_torch_parallel.py: a
module-scoped fixture writes the inputs (seeded numpy; the model's weights
converted from aladin_tpu's Flax parameters; a tiny OSCAR directory and
recipe for cli/train) and starts four processes that run this file as a
script. They import no JAX, run every check on their rank and write their
arrays as ``rank<r>.npz``; the pytest process computes the one-process and
aladin_tpu results and each test asserts one of them. The workers run
under ``communicate(timeout=...)``; the module takes ~50 s of one worker.

Meshes: dp=2,tp=2 and dp=1,tp=4 over the 4 ranks, and dp=1,tp=2 over each
pair of ranks {0, 1} and {2, 3} (a Mesh built on those sub-groups).

Tolerances:
  * the tp train steps (f32, dropout 0) against the port's one-process step
    on the whole batch: the loss terms and grad_norm rtol 1e-5; the
    parameters after clip + Adam rtol 1e-5 (atol 1e-7) where |g| exceeds
    1e-4 of the largest gradient entry, and within 2 lr elsewhere (Adam's
    first step turns rounding noise of a gradient near 0 into an update of
    up to lr of either sign; tests/test_torch_train.py). The tp step sums
    the row-parallel partial products over the ranks in f32, so it differs
    from one process only in summation order;
  * the same steps against aladin_tpu's single-device step: the step
    tolerances of tests/test_torch_train.py (metrics rtol 1e-4; parameters
    atol 1e-6 where the gradient is live, within 2 lr elsewhere);
  * K2 (the fused attention, its plain version on the CPU) at dropout 0.1
    under tp: its masks are the tp = 1 masks, so the step equals the
    one-process step within the f32 tolerances above;
  * replicated activations under dropout 0.1: equal bit for bit on the tp
    ranks of a dp group; the sharded attention dropout: each rank's slice
    of one draw of the whole tensor, bit for bit;
  * cli/test under dp=2,tp=2 against one process: scores atol 1e-4, R@K
    equal (the encode is unsharded; only the scoring is sharded).
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import CLI_DIMS, _write_cli_inputs, hit_rows, search_query_argv
from tests.test_torch_parallel import cli_test_argv as recipe_argv
from tests.test_torch_threads import _two_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 300  # seconds for the whole cluster
LR = 1e-3
B = 8
SMALL = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=64, img_feature_dim=20)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
RECIPE = {"model": {"embed-size": 32, "tern-layers": 1, "dropout": 0.0},
          "training": {"loss-type": "alignment-distillation", "loss-weights": [1, 1],
                       "lr": LR, "bs": B, "grad-clip": 2.0}}
MESHES = ("dp=2,tp=2", "dp=1,tp=4", "dp=1,tp=2")
CURVE = ["curve", "--device", "cpu", "--shortlists", "2,4"]
K2_DROPOUT = dict(fused_attention=True, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.1)


def _torch_batch(batch, rows=slice(None)):
    from aladin_torch.models.aladin import Batch

    return Batch(**{f: torch.from_numpy(np.array(batch[f][rows]))
                    for f in Batch.__dataclass_fields__})


def one_process_step(batch, sd, recipe=RECIPE, bert_over=NO_DROPOUT, seed=None):
    """The port's single-process step on the whole batch: (metrics, params,
    grads by name). ``seed``: the K2 seed generator's seed."""
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.models.aladin import ALADIN
    from aladin_torch.models.bert_img import BertImgConfig
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_loss_fn, make_train_step

    cfg = ExperimentConfig.from_dict(recipe)
    tb = _torch_batch(batch)

    def fresh():
        model = ALADIN(cfg, BertImgConfig(**SMALL, **bert_over))
        model.load_state_dict(sd, strict=True)
        if seed is not None:
            model.oscar_model.bert.seed_generator.manual_seed(seed)
        return model, TrainState(cfg, model, steps_per_epoch=10)

    model, state = fresh()
    model.train()
    make_loss_fn(model, cfg)(state.aux, tb, 0)[0].backward()
    grads = {n: p.grad.clone() for n, p in state.named_params().items() if p.grad is not None}
    model, state = fresh()
    metrics = make_train_step(model, cfg)(state, tb, 0)
    params = {n: p.detach().clone() for n, p in state.named_params().items()}
    return {k: v.item() for k, v in metrics.items()}, params, grads


def _pair_mesh(rank: int):
    """A dp=1,tp=2 mesh over this rank's pair {0, 1} or {2, 3}: both pairs'
    groups are created on every rank, in the same order."""
    import torch.distributed as dist

    from aladin_torch.parallel.mesh import Mesh

    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    g = groups[rank // 2]
    return Mesh({"dp": 1, "tp": 2}, g, rank % 2, torch.device("cpu"), None, g)


def _worker(rank: int, port: str, work: str) -> None:  # noqa: C901 - one rank's checks
    sys.path.insert(0, REPO)
    sys.modules["torch.utils.tensorboard"] = None  # rank 0's no-op writer: no TensorFlow
    from aladin_torch.cli import parity as parity_cli
    from aladin_torch.cli import search as search_cli
    from aladin_torch.cli import test as test_cli
    from aladin_torch.cli import train as train_cli
    from aladin_torch.cli.common import shard_state_and_loaders
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.data.pipeline import BatchLoader
    from aladin_torch.models.aladin import ALADIN
    from aladin_torch.models.bert_img import BertImgConfig
    from aladin_torch.parallel import distributed as D
    from aladin_torch.parallel.mesh import all_gather_cat, create_mesh
    from aladin_torch.parallel.sharding import full_state_dict, sharded_dropout
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_loss_fn, make_train_step

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(WORLD),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    D.initialize(device="cpu")
    out = {}
    meshes = {"dp=2,tp=2": create_mesh("dp=2,tp=2", "cpu"),
              "dp=1,tp=4": create_mesh("dp=1,tp=4", "cpu"), "dp=1,tp=2": _pair_mesh(rank)}
    m = meshes["dp=2,tp=2"]
    out["mesh_2x2"] = np.asarray([m.dp_index, m.tp_index, m.dp, m.tp])

    batch = dict(np.load(os.path.join(work, "train_batch.npz")))
    sd = torch.load(os.path.join(work, "train_sd.pt"), weights_only=True)

    def sharded(mesh, recipe=RECIPE, bert_over=NO_DROPOUT):
        cfg = ExperimentConfig.from_dict(recipe)
        model = ALADIN(cfg, BertImgConfig(**SMALL, **bert_over))
        model.load_state_dict(sd, strict=True)
        state = TrainState(cfg, model, steps_per_epoch=10)
        shard_state_and_loaders(state, mesh, cfg, 88, BatchLoader(range(B), B))
        return cfg, model, state

    def step(tag, mesh, recipe=RECIPE, bert_over=NO_DROPOUT):
        cfg, model, state = sharded(mesh, recipe, bert_over)
        rows = B // mesh.dp
        local = _torch_batch(batch, slice(mesh.dp_index * rows, (mesh.dp_index + 1) * rows))
        metrics = make_train_step(model, cfg, mesh=mesh)(state, local, 0)
        out.update({f"{tag}_metric.{k}": v.item() for k, v in metrics.items()})
        full = full_state_dict(model, mesh)
        for name, p in model.named_parameters():
            out[f"{tag}_param.{name}"] = full[name].numpy()
            out[f"{tag}_local_shape.{name}"] = np.asarray(p.shape)
        for name, p in state.aux.items():
            out[f"{tag}_param.aux.{name}"] = p.detach().numpy()

    # 1. one train step on each mesh (f32, dropout 0), and with K2 at dropout 0.1
    for spec in MESHES:
        step(spec, meshes[spec])
    step("k2_dropout", meshes["dp=1,tp=4"], bert_over=K2_DROPOUT)

    # 2. dropout 0.1 everywhere: replicated activations equal on the tp ranks
    #    of a dp group (the same rows on every rank), the dp groups differ
    drop = {**RECIPE, "model": {**RECIPE["model"], "dropout": 0.1}}
    cfg, model, state = sharded(meshes["dp=2,tp=2"], drop, {})
    model.train()
    loss, _ = make_loss_fn(model, cfg, mesh=None)(state.aux, _torch_batch(batch, slice(0, 4)), 0)
    out["dropout_loss"] = loss.item()
    # the sharded attention dropout: this rank's slice of one draw
    tp4 = meshes["dp=1,tp=4"]
    torch.manual_seed(3)
    kept = sharded_dropout(torch.ones(2, 1, 6, 6), 0.5, True, tp4, dim=1)
    out["probs_mask"] = all_gather_cat(tp4, kept, dim=1, axis="tp").numpy()

    # 3. cli/train at dp=2,tp=2 (rank 0 writes the full tensors), then
    #    cli/test and cli/parity on its checkpoint under the same mesh
    run_dir = os.path.join(work, "cli_tp")
    argv = ["--config", os.path.join(work, "recipe.json"), "--eval_model_dir",
            os.path.join(work, "oscar"), "--output_dir", run_dir, "--logger_name", run_dir,
            "--mesh_shape", "dp=2,tp=2", *CLI_DIMS]
    res = train_cli.run(argv + ["--num_epochs", "1"])
    out["cli_steps"] = res["state"].step
    out["cli_best_rsum"] = res["trainer"].best_rsum
    ckpt = res["checkpoint"]
    del res
    res = test_cli.run(cli_test_argv(work, ckpt, os.path.join(work, "test_tp"))
                       + ["--mesh_shape", "dp=2,tp=2"])
    out["cli_test_scores"] = res["scores"]
    out["cli_test_rsum"] = res["matching"]["rsum"]
    res = parity_cli.run(parity_argv(work, ckpt, os.path.join(work, "parity_tp"))
                         + ["--mesh_shape", "dp=2,tp=2"])
    out["parity_rc"] = res["exit_code"]
    out["parity_scores"] = res["scores_5k"]
    for direction in ("t2i", "i2t"):
        hits = search_cli.run(search_query_argv(work, direction) + ["--mesh_shape", "dp=2,tp=2"])
        out[f"cli_search_{direction}"] = hit_rows(hits)
    curve = search_cli.run(CURVE + ["--index_dir", os.path.join(work, "index"),
                                    "--mesh_shape", "dp=2,tp=2"])
    out["cli_curve"] = curve_ends(curve)

    D.barrier("done")
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} OK")


def curve_ends(curve) -> np.ndarray:
    """R@K of cli/search curve's matching-only and full-rerank rows."""
    return np.asarray([[r["recall"][k] for k in curve["ks"]] for r in curve["rows"]
                       if r["stage"] in ("matching-only", "full-rerank")])


def cli_test_argv(work: str, ckpt: str, out_dir: str):
    return ["--load_checkpoint", ckpt, "--eval_model_dir", os.path.join(work, "oscar"),
            "--output_dir", out_dir, "--logger_name", out_dir,
            *[a for a in CLI_DIMS if a not in ("--log_step", "100", "--val_step", "0")]]


def parity_argv(work: str, ckpt: str, report_dir: str):
    return ["--load_checkpoint", ckpt, "--eval_model_dir", os.path.join(work, "oscar"),
            "--output_dir", os.path.join(work, "parity_data"), "--report_dir", report_dir,
            "--latency_serial", "4",
            *[a for a in CLI_DIMS if a not in ("--log_step", "100", "--val_step", "0",
                                               "--num_workers", "1")]]


class Cluster:
    """The four worker processes and, once they end, their results."""

    def __init__(self, work: str):
        self.work = work
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                                        str(port), work], cwd=REPO, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
                      for r in range(WORLD)]
        self._ranks = None

    def ranks(self):
        """Every rank's results: waits for the workers once."""
        if self._ranks is None:
            try:
                outs = [p.communicate(timeout=TIMEOUT)[0] for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            failed = [f"rank {r} failed:\n{text[-3000:]}"
                      for r, (p, text) in enumerate(zip(self.procs, outs))
                      if p.returncode != 0 or f"rank {r} OK" not in text]
            assert not failed, "\n".join(failed)
            self._ranks = [dict(np.load(os.path.join(self.work, f"rank{r}.npz")))
                           for r in range(WORLD)]
        return self._ranks


def _jax_train_inputs():
    """(aladin_tpu model, its config, Flax params, the (8-row) numpy batch)."""
    import jax

    from aladin_tpu.config import ExperimentConfig as JaxExperimentConfig
    from aladin_tpu.models.aladin import ALADIN as JaxALADIN
    from tests.test_models import make_batch, small_cfg

    jcfg = JaxExperimentConfig.from_dict(RECIPE)
    jmodel = JaxALADIN(jcfg, dataclasses.replace(small_cfg(), **NO_DROPOUT))
    jbatch = make_batch(np.random.RandomState(0), b=B)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, True)["params"]
    batch = {f: np.asarray(getattr(jbatch, f)) for f in jbatch.__dataclass_fields__}
    return jmodel, jcfg, params, batch


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    import jax

    from aladin_torch.io.convert import state_dict_from_flax

    work = str(tmp_path_factory.mktemp("tp"))
    jmodel, jcfg, params, batch = _jax_train_inputs()
    torch.save(state_dict_from_flax(jax.tree.map(np.asarray, params)),
               os.path.join(work, "train_sd.pt"))
    np.savez(os.path.join(work, "train_batch.npz"), **batch)
    _write_cli_inputs(work)
    from aladin_torch.cli import search as search_cli

    search_cli.run(["build", "--index_dir", os.path.join(work, "index"),
                    *recipe_argv(work, os.path.join(work, "index_run"))])
    c = Cluster(work)
    c.jax_train = (jmodel, jcfg, params, batch)
    yield c
    for p in c.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _split(res, tag):
    metrics = {k[len(tag) + 8:]: float(v) for k, v in res.items()
               if k.startswith(f"{tag}_metric.")}
    params = {k[len(tag) + 7:]: v for k, v in res.items() if k.startswith(f"{tag}_param.")}
    return metrics, params


def _assert_close(got_m, got_p, want_m, want_p, grads, rtol, atol):
    scale = max(float(g.abs().max()) for g in grads.values())
    for k in ("loss", "grad_norm", "alignment_loss", "distillation_loss"):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=rtol, err_msg=k)
    assert set(got_p) == set(want_p)
    for name, w in want_p.items():
        w = np.asarray(w)
        got = got_p[name]
        assert got.shape == w.shape, name
        live = (np.abs(grads[name].numpy()) > 1e-4 * scale if name in grads
                else np.zeros(w.shape, bool))
        np.testing.assert_allclose(got[live], w[live], rtol=rtol, atol=atol, err_msg=name)
        assert np.all(np.abs(got - w) <= 2 * LR * 1.001), name


@pytest.fixture(scope="module")
def references(cluster):
    """(the port's one-process step: metrics, params, grads; aladin_tpu's
    single-device step: metrics, params) on the whole batch, once."""
    import jax
    import jax.numpy as jnp

    from aladin_torch.io.convert import params_from_flax
    from aladin_tpu.data.pipeline import batch_from_numpy
    from aladin_tpu.train.state import create_train_state
    from aladin_tpu.train.step import make_train_step as jax_make_train_step

    sd = torch.load(os.path.join(cluster.work, "train_sd.pt"), weights_only=True)
    jmodel, jcfg, jparams, batch = cluster.jax_train
    one = one_process_step(batch, sd)
    jstate = create_train_state(jcfg, jparams, steps_per_epoch=10)
    new_state, jm = jax_make_train_step(jmodel, jcfg)(
        jstate, batch_from_numpy(batch), jnp.int32(0), jax.random.PRNGKey(1))
    jax_p = {k: v.numpy() for k, v in
             params_from_flax(jax.tree.map(np.asarray, new_state.params)).items()}
    return one, ({k: float(v) for k, v in jm.items()}, jax_p)


@pytest.mark.parametrize("spec", MESHES)
def test_tp_step_matches_one_process_and_jax(cluster, references, spec):
    """One flagship step (f32, dropout 0) on each mesh over a global batch
    of 8: loss, grad_norm and every parameter after the step (gathered to
    full shapes) within 1e-5 relative of the port's one-process step, and
    within the step tolerances of aladin_tpu's single-device step; equal on
    every rank."""
    ranks = cluster.ranks()
    got_m, got_p = _split(ranks[0], spec)
    for r in ranks[1:]:
        m, p = _split(r, spec)
        assert m == got_m
        for k in got_p:
            np.testing.assert_array_equal(p[k], got_p[k], err_msg=k)
    (want_m, want_p, grads), (jax_m, jax_p) = references
    _assert_close(got_m, got_p, want_m, {k: v.numpy() for k, v in want_p.items()}, grads,
                  rtol=1e-5, atol=1e-7)
    _assert_close(got_m, got_p, jax_m, jax_p, grads, rtol=1e-4, atol=1e-6)


def test_tp_ranks_hold_their_slices(cluster):
    """Rank ids and local shapes: tp is the fastest axis (rank = dp_index *
    tp + tp_index); each tp rank of dp=1,tp=4 holds a quarter of the QKV
    rows, the FFN rows, the attention-out and FFN-down columns and the
    packed TE projection, and the whole of the replicated tensors."""
    ranks = cluster.ranks()
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["mesh_2x2"], [r // 2, r % 2, 2, 2])
    shapes = {k.split("local_shape.", 1)[1]: tuple(v) for k, v in ranks[0].items()
              if k.startswith("dp=1,tp=4_local_shape.")}
    bert = "oscar_model.bert.encoder.layer.0."
    assert shapes[bert + "attention.self.query.weight"] == (8, 32)
    assert shapes[bert + "attention.self.query.bias"] == (8,)
    assert shapes[bert + "intermediate.dense.weight"] == (16, 32)
    assert shapes[bert + "attention.output.dense.weight"] == (32, 8)
    assert shapes[bert + "attention.output.dense.bias"] == (32,)
    assert shapes[bert + "output.dense.weight"] == (32, 16)
    te = "final_projection_net.layers.0."
    assert shapes[te + "self_attn.in_proj_weight"] == (24, 32)
    assert shapes[te + "self_attn.out_proj.weight"] == (32, 8)
    assert shapes[te + "linear1.weight"] == (8, 32)
    assert shapes[te + "linear2.weight"] == (32, 8)
    assert shapes["oscar_model.bert.embeddings.word_embeddings.weight"] == (97, 32)
    assert shapes[bert + "output.LayerNorm.weight"] == (32,)


def test_k2_under_tp_draws_the_tp1_masks(cluster):
    """The step with fused_attention at attention dropout 0.1 (the other
    dropouts 0) on dp=1,tp=4: each rank's K2 hashes its heads' global
    index, so the masks, and so the step, equal the one-process step's
    with the same K2 seed generator (rank 0 keeps the seed 88)."""
    sd = torch.load(os.path.join(cluster.work, "train_sd.pt"), weights_only=True)
    batch = cluster.jax_train[3]
    want_m, want_p, grads = one_process_step(batch, sd, bert_over=K2_DROPOUT, seed=88)
    got_m, got_p = _split(cluster.ranks()[0], "k2_dropout")
    _assert_close(got_m, got_p, want_m, {k: v.numpy() for k, v in want_p.items()}, grads,
                  rtol=1e-5, atol=1e-7)
    # and the masks were on: the loss differs from the dropout-0 step's
    assert abs(want_m["loss"] - _split(cluster.ranks()[0], "dp=1,tp=4")[0]["loss"]) > 1e-6


def test_replicated_dropout_masks_equal_across_tp_ranks(cluster):
    """Dropout 0.1 everywhere on dp=2,tp=2, the same 4 rows on every rank:
    the loss (a function of replicated activations only) is equal bit for
    bit on the two tp ranks of a dp group, and differs between the dp
    groups (the dp index is folded into the generators)."""
    r = [float(res["dropout_loss"]) for res in cluster.ranks()]
    assert r[0] == r[1] and r[2] == r[3]
    assert r[0] != r[2]


def test_sharded_attention_dropout_is_a_slice_of_one_draw(cluster):
    """sharded_dropout on dp=1,tp=4: the four ranks' masks, gathered, are
    one draw of the whole (2, 4, 6, 6) tensor from the shared generator
    (the same on every rank), so no two heads share a mask."""
    got = cluster.ranks()[0]["probs_mask"]
    for res in cluster.ranks()[1:]:
        np.testing.assert_array_equal(res["probs_mask"], got)
    torch.manual_seed(3)
    want = (torch.rand(2, 4, 6, 6) >= 0.5).float() * 2.0
    np.testing.assert_array_equal(got, want.numpy())
    heads = got.transpose(1, 0, 2, 3).reshape(4, -1)
    assert all(not np.array_equal(heads[i], heads[j]) for i in range(4) for j in range(i))


def test_tp_checkpoint_has_reference_keys_and_full_shapes(cluster, tmp_path):
    """The .pth.tar of cli/train at dp=2,tp=2: the keys and full shapes of a
    one-process model (io/convert.py's names) and Adam's moments at full
    shapes too; it loads into a tp = 1 port model strictly, and
    aladin_tpu.io.convert reads it into exactly the leaves and shapes it
    reads from a one-process model's file."""
    import argparse

    import jax

    from aladin_torch.cli.common import _build_aladin, add_shared_flags, to_data_args
    from aladin_torch.config import load_config
    from aladin_torch.io.checkpoint import save_checkpoint
    from aladin_torch.train.state import TrainState
    from aladin_tpu.io.convert import load_aladin_checkpoint as jax_load

    cluster.ranks()
    path = os.path.join(cluster.work, "cli_tp", "checkpoint.pth.tar")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k[len("img_txt_enc."):]: v for k, v in ckpt["model"].items()}
    p = argparse.ArgumentParser()
    add_shared_flags(p)
    args = to_data_args(p.parse_args(["--eval_model_dir", os.path.join(cluster.work, "oscar"),
                                      "--img_feature_dim", "32"]))
    cfg = load_config(os.path.join(cluster.work, "recipe.json"))
    model = _build_aladin(cfg, args)
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    model.load_state_dict(sd, strict=True)
    state = TrainState(cfg, model)
    params = [q for g in state.optimizer.param_groups for q in g["params"]]
    assert ckpt["optimizer"]["state"]  # the parameters with a gradient (no pooler)
    for i, st in ckpt["optimizer"]["state"].items():
        assert tuple(st["exp_avg"].shape) == tuple(params[i].shape), i
        assert tuple(st["exp_avg_sq"].shape) == tuple(params[i].shape), i
    state.load_optimizer_state_dict(ckpt["optimizer"])

    one = save_checkpoint(str(tmp_path), state, 1, cfg.to_dict(), 0.0)

    def leaves(file):
        tree = jax_load(file)[0]
        return {jax.tree_util.keystr(kp): np.shape(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    want = leaves(one)
    assert want and leaves(path) == want


def test_save_on_tp_then_resume_on_one_process(cluster, tmp_path):
    """cli/train wrote its checkpoint at dp=2,tp=2; --resume on one process
    (tp = 1) continues from it: the step count and a second epoch run."""
    from aladin_torch.cli import train as torch_train_cli

    res = cluster.ranks()[0]
    path = os.path.join(cluster.work, "cli_tp", "checkpoint.pth.tar")
    run = str(tmp_path / "resume")
    again = torch_train_cli.run(
        ["--config", os.path.join(cluster.work, "recipe.json"), "--eval_model_dir",
         os.path.join(cluster.work, "oscar"), "--output_dir", run, "--logger_name", run,
         *CLI_DIMS, "--num_epochs", "2", "--resume", path])
    assert again["state"].step == 2 * int(res["cli_steps"])
    assert all(torch.isfinite(p).all() for p in again["state"].trainable)


def test_cli_test_and_parity_under_tp_mesh(cluster, tmp_path):
    """cli/test at dp=2,tp=2 on the tp run's checkpoint: the unsharded
    encode and the scoring sharded over every rank give one process's
    scores (atol 1e-4) and R@K; cli/parity runs under the mesh (rc 0)."""
    from aladin_torch.cli import test as torch_test_cli

    path = os.path.join(cluster.work, "cli_tp", "checkpoint.pth.tar")
    want = torch_test_cli.run(cli_test_argv(cluster.work, path, str(tmp_path / "one")))
    for res in cluster.ranks():
        np.testing.assert_allclose(res["cli_test_scores"], want["scores"], atol=1e-4)
        assert float(res["cli_test_rsum"]) == pytest.approx(want["matching"]["rsum"])
        assert int(res["parity_rc"]) == 0



@pytest.mark.parametrize("direction", ["t2i", "i2t"])
def test_cli_search_under_tp_mesh(cluster, direction):
    """cli/search query and curve at dp=2,tp=2: the corpus sharded over all
    four ranks returns the one-process hits, and the curve's matching-only
    and full-rerank rows (a reranked shortlist is each shard's, so its rows
    cover more candidates than one process's, as in aladin_tpu)."""
    from aladin_torch.cli import search as search_cli

    want = hit_rows(search_cli.run(search_query_argv(cluster.work, direction)))
    curve = search_cli.run(CURVE + ["--index_dir", os.path.join(cluster.work, "index")])
    want_curve = curve_ends(curve)
    for res in cluster.ranks():
        np.testing.assert_allclose(res[f"cli_search_{direction}"], want, atol=1e-4)
        np.testing.assert_array_equal(res["cli_curve"], want_curve)


# ---------------------------------------------------------------------------
# one process: K2's head numbering, the packed slicing, the refusals


@pytest.mark.parametrize("tp", [2, 4])
def test_k2_keep_mask_at_head_offset_is_the_full_masks_slice(tp):
    """K2's keep mask of heads [offset, offset + H/tp) of a 12-head layer
    equals that slice of the 12-head mask bit for bit; the default
    arguments give the hash of (b * H + h) they always gave; and the plain
    forward / backward at a head offset equal the head slice of the full
    launch's at dropout 0.1 (bit for bit: the same f32 arithmetic a head)."""
    from aladin_torch.ops.kernels import attention_kernel as ak

    b, h, s, rate, seed = 3, 12, 7, 0.1, 12345
    full = ak.keep_mask(seed, b, h, s, rate)
    qk = torch.arange(s * s, dtype=torch.int64).reshape(1, 1, s, s)
    bh = torch.arange(b * h, dtype=torch.int64).reshape(b, h, 1, 1)
    legacy = ak._mix32(ak._mix32(ak._mix32(seed) ^ bh) ^ qk) >= ak._threshold(rate)
    assert torch.equal(full, legacy)
    local = h // tp
    rng = np.random.RandomState(tp)
    q, k, v, g = (torch.from_numpy(rng.randn(b, s, h, 64).astype(np.float32)) for _ in range(4))
    bias = torch.from_numpy(np.where(rng.rand(b, 1, s) < 0.2, -1e4, 0.0).astype(np.float32))
    ctx = ak.attention_forward_plain(q, k, v, bias, seed, rate, True)
    grads = ak.attention_backward_plain(q, k, v, bias, g, seed, rate, True)
    for t in range(tp):
        sl = slice(t * local, (t + 1) * local)
        assert torch.equal(ak.keep_mask(seed, b, local, s, rate, "cpu", h, t * local),
                           full[:, sl])
        args = [x[:, :, sl].contiguous() for x in (q, k, v)]
        got = ak.fused_attention(*args, bias, seed, rate, True, heads_total=h,
                                 head_offset=t * local)
        assert torch.equal(got, ctx[:, :, sl])
        got_g = ak.attention_backward_plain(*args, bias, g[:, :, sl].contiguous(), seed, rate,
                                            True, h, t * local)
        for a_, w in zip(got_g, grads):
            assert torch.equal(a_, w[:, :, sl])


def test_packed_in_proj_slices_each_of_q_k_v():
    """A packed (3E, E) in_proj and its (3E,) bias: rank t of tp keeps its
    heads' rows of each of the q, k and v blocks (not a contiguous third),
    and the gather's layout puts them back in place."""
    from aladin_torch.parallel.sharding import _split_view, shard_tensor, spec_for

    e, tp = 8, 4
    w = torch.arange(3 * e * e, dtype=torch.float32).reshape(3 * e, e)
    bias = torch.arange(3 * e, dtype=torch.float32)
    assert spec_for("final_projection_net.layers.0.self_attn.in_proj_weight") == "packed"
    assert spec_for("depth_aggregator_model_alignment.self_attn.in_proj_bias") == "packed"
    parts, bparts = [], []
    for t in range(tp):
        rows = [blk * e + t * (e // tp) + i for blk in range(3) for i in range(e // tp)]
        got = shard_tensor(w, "packed", tp, t)
        assert torch.equal(got, w[rows])
        assert torch.equal(shard_tensor(bias, "packed", tp, t), bias[rows])
        parts.append(_split_view(got, "packed")[0])
        bparts.append(_split_view(shard_tensor(bias, "packed", tp, t), "packed")[0])
    # what gather_tensor assembles from the ranks' slices
    assert torch.equal(torch.cat(parts, dim=1).reshape(3 * e, e), w)
    assert torch.equal(torch.cat(bparts, dim=1).reshape(3 * e), bias)
    assert torch.equal(shard_tensor(w, "row", 2, 1), w[:, e // 2:])
    assert torch.equal(shard_tensor(w, "column", 2, 1), w[3 * e // 2:])


def test_row_parallel_linear_rounds_once_under_bf16_autocast():
    """On one rank (no tp group) a row-parallel layer under bf16 autocast is
    the autocast layer within one bf16 rounding, forward and backward: the
    partial product has an f32 result, the bias is added in f32 and the sum
    rounded once; the backward's products take bf16 operands, as the
    layer's. On the CPU the partial product multiplies the upcast operands."""
    from aladin_torch.parallel.mesh import Mesh
    from aladin_torch.parallel.sharding import _PartialProduct, row_parallel_linear

    rng = np.random.default_rng(14)
    mesh = Mesh(axes={"dp": 1, "tp": 1}, group=None, rank=0, device=torch.device("cpu"))
    layer = torch.nn.Linear(48, 16)
    h = torch.tensor(rng.standard_normal((2, 5, 48)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((2, 5, 16)), dtype=torch.bfloat16)
    out = []
    for fn in (layer, lambda x: row_parallel_linear(x, layer, mesh)):
        x = h.clone().requires_grad_()
        layer.zero_grad()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = fn(x)
        y.backward(g)
        out.append((y, x.grad, layer.weight.grad.clone(), layer.bias.grad.clone()))
    (y0, dx0, dw0, db0), (y1, dx1, dw1, db1) = out
    assert y1.dtype == y0.dtype == torch.bfloat16
    ulp = 2.0 ** -7
    for got, want in ((y1.detach(), y0.detach()), (dx1, dx0), (dw1, dw0), (db1, db0)):
        assert got.dtype == want.dtype
        assert torch.allclose(got.float(), want.float(), rtol=ulp, atol=ulp * 1e-3 * float(
            want.float().abs().max()))
    hb, wb = h.reshape(10, 48).bfloat16(), layer.weight.detach().bfloat16()
    part = _PartialProduct.apply(hb, wb)
    assert part.dtype == torch.float32
    assert torch.allclose(part, hb.float() @ wb.float().t(), rtol=1e-6, atol=1e-6)


def test_sharding_rules_follow_the_reference_names():
    """Column-parallel: QKV and FFN-up (weight and bias); row-parallel: the
    attention-out and FFN-down weights, their biases replicated; the rest
    replicated."""
    from aladin_torch.parallel.sharding import spec_for

    layer = "oscar_model.bert.encoder.layer.3."
    te = "transformer_encoder_1.layers.0."
    assert {n: spec_for(layer + n) for n in (
        "attention.self.query.weight", "attention.self.value.bias", "intermediate.dense.bias",
        "attention.output.dense.weight", "attention.output.dense.bias",
        "output.dense.weight", "output.dense.bias", "output.LayerNorm.weight")} == {
        "attention.self.query.weight": "column", "attention.self.value.bias": "column",
        "intermediate.dense.bias": "column", "attention.output.dense.weight": "row",
        "attention.output.dense.bias": None, "output.dense.weight": "row",
        "output.dense.bias": None, "output.LayerNorm.weight": None}
    assert [spec_for(te + n) for n in ("linear1.weight", "linear2.weight", "linear2.bias",
                                       "self_attn.out_proj.weight", "norm1.weight")] == [
        "column", "row", None, "row", None]
    for name in ("oscar_model.bert.embeddings.word_embeddings.weight",
                 "oscar_model.bert.pooler.dense.weight", "feature_fusion.alphas.0.weight",
                 "oscar_model.bert.img_embedding.weight"):
        assert spec_for(name) is None, name


def test_check_tp_names_the_layer_and_refuses_int8():
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.models.aladin import ALADIN
    from aladin_torch.models.bert_img import BertImgConfig
    from aladin_torch.parallel.sharding import check_tp

    model = ALADIN(ExperimentConfig.from_dict(RECIPE), BertImgConfig(**SMALL))
    check_tp(model, 1)
    check_tp(model, 2)
    check_tp(model, 4)
    with pytest.raises(ValueError, match=r"tp=3 does not divide the 4 heads of "
                                         r"oscar_model\.bert\.encoder\.layer\.0"):
        check_tp(model, 3)
    with pytest.raises(ValueError, match=r"tp=8 does not divide the 4 heads"):
        check_tp(model, 8)
    quant = ALADIN(ExperimentConfig.from_dict(RECIPE), BertImgConfig(**SMALL, quant_matmuls=True))
    with pytest.raises(ValueError, match="int8 encoder"):
        check_tp(quant, 2)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
