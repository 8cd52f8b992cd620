"""Data parallelism in aladin_torch on a 2-rank gloo group on the CPU: the
process group (parallel/distributed.py), the corpus-sharded scorers
(parallel/mesh.py), compute_recall_from_scores, sharded_search, the
streaming mesh sweeps, the data-parallel train step, cli/train with
--mesh_shape dp=2 and its checkpoint, the OSCAR task steps (pretraining,
classification, captioning with drop-worst, the retrieval pair step, SCST),
cli/pretrain, cli/classify, cli/captioning and cli/retrieval_oscar at dp=2,
against aladin_tpu on ``create_mesh("dp=2")`` (2
of conftest.py's 8 virtual CPU devices) and against the port's
single-process results.

One cluster serves the module. A module-scoped fixture writes the inputs
(seeded numpy; the train model's weights converted from aladin_tpu's Flax
parameters; a tiny OSCAR directory and recipe for cli/train), then starts
two processes that run this file as a script: they import no JAX and no
conftest.py, run every check on their rank and write their arrays as
``rank<r>.npz``. The pytest process computes aladin_tpu's results
meanwhile; each test reads one result and asserts it. Every process runs
under ``communicate(timeout=...)``, so a hang fails the tests.

Tolerances:
  * scores: f32 / bf16 operands with f32 sums, atol 1e-4; int8, atol 1e-5
    (the integer sums are exact, and each shard has its own scales on both
    sides) - those of tests/test_torch_alignment.py;
  * ranks, search indices and streamed ranks: equal;
  * the train step (dropout 0): tests/test_torch_train.py's step
    tolerances - metrics rtol 1e-4, params atol 1e-6 where the gradient is
    live and within lr elsewhere;
  * the OSCAR task steps at dp=2 (pretraining, the kl classifier,
    captioning with drop-worst over the gathered global tokens, the ce pair
    step): the losses rtol 1e-5, the parameters as the train step's; the
    SCST step (the whole batch on each rank): equal on both ranks, within
    1e-6 of one process's;
  * cli/train dp=2 against dp=1, dropout 0 (an OSCAR directory whose
    config sets the backbone's dropouts to 0 and a recipe with dropout 0),
    lr 1e-3 and ``--compute_dtype float32``: best rsum within 2.6 and the
    layer-0 intermediate weight within 2e-4, the bounds of
    tests/test_e2e_cli.py::test_train_cli_mesh_matches_unsharded. In bf16
    the two runs' weight gradients round differently (a sum of two 4-row
    GEMMs against one 8-row GEMM), and Adam turns the noise of gradients
    near 0 into updates of up to lr of either sign.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 300  # seconds for the whole cluster
N_IM, CPI, R, W, D = 24, 5, 9, 12, 32
LR = 1e-3
SMALL = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=64, img_feature_dim=20)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
RECIPE = {"model": {"embed-size": 32, "tern-layers": 1, "dropout": 0.0},
          "training": {"loss-type": "alignment-distillation", "loss-weights": [1, 1],
                       "lr": LR, "bs": 8, "grad-clip": 2.0}}
SEARCH_CASES = [(d, r) for d in ("t2i", "i2t") for r in (True, False)]
SEARCH_K, SEARCH_SHORTLIST, N_QUERIES = 5, 4, 16
SYNTH_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "of", "the", "dog",
               "cat", "car", "tree", "person", "boat", "bird", "house", "number"] + [
                  str(i) for i in range(10)]
CLI_DIMS = ["--max_seq_length", "20", "--max_img_seq_length", "12", "--img_feature_dim", "32",
            "--num_workers", "1", "--log_step", "100", "--val_step", "0", "--synthetic",
            "--device", "cpu", "--compute_dtype", "float32"]


def scoring_inputs():
    """(unique image sets (N, R, D), caption sets (5N, W, D), image lengths,
    caption lengths), seeded."""
    rng = np.random.RandomState(0)
    return (rng.randn(N_IM, R, D).astype(np.float32),
            rng.randn(N_IM * CPI, W, D).astype(np.float32),
            rng.randint(3, R + 1, N_IM).astype(np.int32),
            rng.randint(5, W + 1, N_IM * CPI).astype(np.int32))


def unit_globals():
    """l2-normalized (N, D) image and (5N, D) caption embeddings."""
    rng = np.random.RandomState(1)
    ims = rng.randn(N_IM, D).astype(np.float32)
    caps = rng.randn(N_IM * CPI, D).astype(np.float32)
    return (ims / np.linalg.norm(ims, axis=1, keepdims=True),
            caps / np.linalg.norm(caps, axis=1, keepdims=True))


def search_queries(direction, ims, caps, il, cl):
    """(query sets, query lengths) of a direction: captions for t2i, images
    for i2t."""
    return (caps[:N_QUERIES], cl[:N_QUERIES]) if direction == "t2i" else (ims, il)


TASK_CFG = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=64, img_feature_dim=12,
                num_labels=5, **NO_DROPOUT)
TASK_STEPS = {"pretrain": 2, "classify_kl": 2, "caption_dropworst": 2, "pair_ce": 2}
TASK_B = 8
CAPTION_A, CAPTION_OD, CAPTION_R = 6, 4, 3  # caption slots, OD labels, regions


def task_batch():
    """A global batch of 8 for the OSCAR task steps: (ids, mask, seg,
    feats, MLM labels, relation labels, soft VQA targets), seeded numpy."""
    rng = np.random.RandomState(11)
    l, r = 10, 4
    ids = rng.randint(5, 40, (TASK_B, l)).astype(np.int32)
    mask = np.concatenate([np.arange(l) < rng.randint(4, l + 1, (TASK_B, 1)),
                           np.arange(r) < rng.randint(1, r + 1, (TASK_B, 1))], 1).astype(np.int32)
    seg = (rng.rand(TASK_B, l) < 0.3).astype(np.int32)
    feats = rng.randn(TASK_B, r, 12).astype(np.float32)
    lm = np.where(rng.rand(TASK_B, l + r) < 0.25, rng.randint(0, 40, (TASK_B, l + r)), -1)
    lm[:, l:] = -1
    soft = (rng.rand(TASK_B, 5) * (rng.rand(TASK_B, 5) < 0.4)).astype(np.float32)
    return (ids, mask, seg, feats, lm.astype(np.int32), rng.randint(0, 2, TASK_B).astype(
        np.int32), soft)


def caption_batch():
    """A global caption batch of 8: (ids, 2-D block masks, seg, feats,
    masked positions, masked ids with inactive 0 slots), seeded numpy."""
    from aladin_torch.tasks.captioning import _decode_attention_mask

    rng = np.random.RandomState(12)
    la, lt = CAPTION_A, CAPTION_A + CAPTION_OD
    ids = rng.randint(5, 40, (TASK_B, lt)).astype(np.int32)
    seg = np.concatenate([np.zeros((TASK_B, la)), np.ones((TASK_B, CAPTION_OD))], 1)
    masks = np.stack([_decode_attention_mask(la, lt, CAPTION_R, int(o), int(r)) for o, r in
                      zip(rng.randint(1, CAPTION_OD + 1, TASK_B),
                          rng.randint(1, CAPTION_R + 1, TASK_B))])
    feats = rng.randn(TASK_B, CAPTION_R, 12).astype(np.float32)
    midx = rng.randint(1, la, (TASK_B, 3)).astype(np.int32)
    mids = rng.randint(5, 40, (TASK_B, 3)).astype(np.int32)
    mids[rng.rand(TASK_B, 3) < 0.3] = 0
    return ids, masks, seg.astype(np.int32), feats, midx, mids


def _task_model(task: str, cfg):
    from aladin_torch.models.bert_img import ImageBertClassifier
    from aladin_torch.tasks.captioning import BertImageCaptioner
    from aladin_torch.tasks.pretraining import BertImgForPreTraining

    if task == "pretrain":
        return BertImgForPreTraining(cfg)
    return (BertImageCaptioner if task.startswith("caption") else ImageBertClassifier)(cfg)


def run_task_steps(task: str, rank: int = 0, mesh_shape: str = ""):
    """The OSCAR task step (``task``: pretraining, the VQA classifier with
    the kl loss, captioning with drop-worst 0.3, or the retrieval pair step
    with the ce loss) for TASK_STEPS steps at dropout 0, lr 1e-3, on this
    rank's rows of ``task_batch()`` / ``caption_batch()``: (losses, params,
    gradients of each step). With ``mesh_shape`` the model starts from
    weights of the rank's own seed and ``cli/pretrain.py::data_parallel``
    gives it rank 0's and its rows; without, one process runs the whole
    batch from rank 0's."""
    from aladin_torch.cli.pretrain import data_parallel, make_optimizer
    from aladin_torch.models.bert_img import BertImgConfig, init_weights
    from aladin_torch.tasks.captioning import make_caption_train_step
    from aladin_torch.tasks.classification import make_classifier_train_step
    from aladin_torch.tasks.pretraining import make_pretrain_step
    from aladin_torch.tasks.retrieval_oscar import make_pair_train_step

    model = _task_model(task, BertImgConfig(**TASK_CFG))
    init_weights(model, torch.Generator().manual_seed(3 + rank), 0.02)
    mesh, rows = None, slice(0, TASK_B)
    if mesh_shape:
        mesh, rows = data_parallel(model, mesh_shape, TASK_B, 0, "cpu")
    opt, _ = make_optimizer(model, 1e-3, 0, 10)
    ids, mask, seg, feats, lm, nxt, soft = (torch.from_numpy(a[rows]) for a in task_batch())
    if task == "pretrain":
        step, args = make_pretrain_step(model, opt, mesh=mesh), (ids, mask, seg, feats, lm, nxt)
    elif task == "caption_dropworst":
        step = make_caption_train_step(model, opt, 0.1, drop_worst_ratio=0.3, mesh=mesh)
        args = (*(torch.from_numpy(a[rows]) for a in caption_batch()), 0)
    elif task == "pair_ce":
        step = make_pair_train_step(model, opt, "ce", mesh=mesh)
        args = (ids, mask, seg, feats, nxt)
    else:
        step = make_classifier_train_step(model, opt, "kl", mesh=mesh)
        args = (ids, mask, seg, feats, soft)
    losses, grads = [], []
    for _ in range(TASK_STEPS[task]):
        losses.append(step(*args)["loss"].item())
        grads.append({n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for n, p in model.named_parameters()})  # the captioner's pooler: none
    return losses, {n: p.detach().clone() for n, p in model.named_parameters()}, grads


# ---------------------------------------------------------------------------
# the worker: one rank of the gloo group (runs this file as a script)
# ---------------------------------------------------------------------------


def _worker(rank: int, port: str, work: str) -> None:  # noqa: C901 - one rank's checks
    sys.path.insert(0, REPO)
    from aladin_torch.cli import search as search_cli
    from aladin_torch.cli import test as test_cli
    from aladin_torch.cli import train as train_cli
    from aladin_torch.cli.common import shard_state_and_loaders
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.data.pipeline import BatchLoader
    from aladin_torch.eval import search as tsearch
    from aladin_torch.eval import streaming as tst
    from aladin_torch.io import checkpoint as tckpt
    from aladin_torch.models.aladin import ALADIN, Batch
    from aladin_torch.models.bert_img import BertImgConfig
    from aladin_torch.parallel import distributed as D
    from aladin_torch.parallel.mesh import (create_mesh, sharded_matching_scores,
                                            sharded_mrsw_scores)
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_loss_fn, make_train_step

    torch.set_num_threads(2)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(WORLD),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    D.initialize(device="cpu")
    out = {}

    # 1. the process group
    out["world"], out["rank"] = D.get_world_size(), D.get_rank()
    out["is_main"] = D.is_main_process()
    D.barrier("smoke")
    m = D.all_reduce_metrics({"n": 10.0 * (rank + 1), "acc": float(rank + 1)})
    out["mean_acc"], out["mean_n"] = m["acc"], m["n"]
    out["sum_count"] = D.all_reduce_metrics({"count": float(rank + 1)}, op="sum")["count"]
    mesh = create_mesh("dp=2", "cpu")

    # 2. the corpus-sharded scorers
    ims, caps, il, cl = scoring_inputs()
    for name, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        out[f"mrsw_{name}"] = sharded_mrsw_scores(
            mesh, ims, caps, il, cl, use_kernel=True, compute_dtype=dtype,
            small_corpus_fallback=False).numpy()
    out["mrsw_f32"] = sharded_mrsw_scores(mesh, ims, caps, il, cl, use_kernel=False,
                                          small_corpus_fallback=False).numpy()
    img_g, cap_g = unit_globals()
    out["matching"] = sharded_matching_scores(mesh, img_g, cap_g).numpy()

    # 3. sharded search
    for direction, rerank in SEARCH_CASES:
        embs, lens = (ims, il) if direction == "t2i" else (caps, cl)
        corpus = tsearch.build_corpus(embs, lens, device="cpu")
        q_sets, q_lens = search_queries(direction, ims, caps, il, cl)
        s, i = tsearch.sharded_search(mesh, corpus, q_sets, q_lens, direction=direction,
                                      k=SEARCH_K, shortlist=SEARCH_SHORTLIST, rerank=rerank)
        out[f"search_{direction}_{rerank}_scores"], out[f"search_{direction}_{rerank}_idx"] = s, i

    # 4. streaming mesh sweeps, and the solo sweeps on this rank
    for tag, msh in (("mesh", mesh), ("solo", None)):
        kw = {"mesh": msh} if msh is not None else {"device": "cpu"}
        i2t, t2i, (tv, tc) = tst.streaming_matching_ranks(img_g, cap_g, CPI, cap_block=40,
                                                          topk=5, **kw)
        out.update({f"stream_match_{tag}_i2t": i2t, f"stream_match_{tag}_t2i": t2i,
                    f"stream_match_{tag}_topv": tv, f"stream_match_{tag}_topc": tc})
        sets = np.repeat(ims, CPI, axis=0), caps, np.repeat(il, CPI), cl
        for kernel in (False, True):
            a_i2t, a_t2i = tst.streaming_alignment_ranks(*sets, "MrSw", CPI, cap_block=16,
                                                         use_kernel=kernel, **kw)
            out[f"stream_align_{kernel}_{tag}_i2t"] = a_i2t
            out[f"stream_align_{kernel}_{tag}_t2i"] = a_t2i

    # 5. the data-parallel train step
    inp = np.load(os.path.join(work, "train_batch.npz"))
    sd = torch.load(os.path.join(work, "train_sd.pt"), weights_only=True)
    cfg = ExperimentConfig.from_dict(RECIPE)
    rows = slice(rank * 4, (rank + 1) * 4)
    local = Batch(**{f: torch.from_numpy(inp[f][rows]) for f in Batch.__dataclass_fields__})

    def fresh(**bert_over):
        model = ALADIN(cfg, BertImgConfig(**SMALL, **bert_over))
        model.load_state_dict(sd, strict=True)
        return model, TrainState(cfg, model, steps_per_epoch=10)

    model, state = fresh(**NO_DROPOUT)
    metrics = make_train_step(model, cfg, mesh=mesh)(state, local, 0)
    out.update({f"step_{k}": v.item() for k, v in metrics.items()})
    for name, p in state.named_params().items():
        out[f"step_param.{name}"] = p.detach().numpy()

    # three steps at dropout 0.1: the ranks' masks differ, their params stay equal
    dcfg = ExperimentConfig.from_dict({**RECIPE, "model": {**RECIPE["model"], "dropout": 0.1}})
    model = ALADIN(dcfg, BertImgConfig(**SMALL))
    model.load_state_dict(sd, strict=True)
    state = TrainState(dcfg, model, steps_per_epoch=10)
    shard_state_and_loaders(state, mesh, dcfg, 88, BatchLoader(range(8), 8))
    same_rows = Batch(**{f: torch.from_numpy(inp[f][:4]) for f in Batch.__dataclass_fields__})
    model.train()
    out["dropout_loss_folded"] = make_loss_fn(model, dcfg)(state.aux, same_rows, 0)[0].item()
    torch.manual_seed(7)  # the same generator state on both ranks: the same masks
    out["dropout_loss_same_seed"] = make_loss_fn(model, dcfg)(state.aux, same_rows, 0)[0].item()
    step = make_train_step(model, dcfg, mesh=mesh)
    before = torch.cat([p.detach().reshape(-1).clone() for p in state.trainable])
    for _ in range(3):
        step(state, local, 0)
    after = torch.cat([p.detach().reshape(-1) for p in state.trainable])
    out["dropout_params_after_3"] = after.numpy()
    out["dropout_params_moved"] = bool((after != before).any())

    # 5b. the OSCAR task steps and cli/pretrain / cli/classify at dp=2 (TensorBoard's
    # writer unimportable: rank 0 takes the no-op writer and imports no TensorFlow)
    sys.modules["torch.utils.tensorboard"] = None
    for task in TASK_STEPS:
        losses, params, _ = run_task_steps(task, rank, "dp=2")
        out[f"{task}_losses"] = np.asarray(losses)
        out.update({f"{task}_param.{k}": v.numpy() for k, v in params.items()})
    from aladin_torch.cli import classify as classify_cli
    from aladin_torch.cli import pretrain as pretrain_cli

    dims = ["--max_seq_length", "24", "--max_img_seq_length", "8", "--img_feature_dim", "16",
            "--synthetic", "--device", "cpu", "--mesh_shape", "dp=2"]
    res = pretrain_cli.run(["--output_dir", os.path.join(work, "pretrain_dp2"), "--max_iters",
                            "2", "--log_step", "1", "--train_batch_size", "4", *dims])
    out["pretrain_cli_losses"] = np.asarray([r["loss"] for r in res["log"]])
    out["pretrain_cli_params"] = torch.cat([p.detach().reshape(-1)
                                            for p in res["model"].parameters()]).numpy()
    out["pretrain_cli_ckpt"] = res["checkpoints"][-1]
    res = classify_cli.run(["--task", "vqa", "--loss_type", "kl", "--epochs", "1", "--do_test",
                            "--train_batch_size", "8", "--output_dir",
                            os.path.join(work, "classify_dp2"), *dims])
    out["classify_cli_losses"] = np.asarray(res["losses"])
    out["classify_cli_params"] = torch.cat([p.detach().reshape(-1)
                                            for p in res["model"].parameters()]).numpy()
    out["classify_cli_results"] = res["test_results"]
    out.update(scst_step_params(rank, "dp=2"))
    from aladin_torch.cli import captioning as captioning_cli
    from aladin_torch.cli import retrieval_oscar as ro_cli

    res = captioning_cli.run(["--output_dir", os.path.join(work, "captioning_dp2"), "--epochs",
                              "1", "--scst_epochs", "1", "--train_batch_size", "8",
                              "--max_seq_a_length", "10", *dims])
    out["captioning_cli_losses"] = np.asarray(res["losses"][0] + res["scst_losses"][0])
    out["captioning_cli_params"] = torch.cat([p.detach().reshape(-1)
                                              for p in res["model"].parameters()]).numpy()
    out["captioning_cli_preds"] = np.asarray([res["predictions"][k][0]
                                              for k in sorted(res["predictions"])])
    res = ro_cli.run(["--output_dir", os.path.join(work, "retrieval_oscar_dp2"), "--epochs", "1",
                      "--train_batch_size", "8", *dims])
    out["retrieval_oscar_cli_losses"] = np.asarray([m["loss"] for m in res["metrics"]])
    out["retrieval_oscar_cli_params"] = torch.cat([p.detach().reshape(-1)
                                                   for p in res["model"].parameters()]).numpy()
    out["retrieval_oscar_cli_rsum"] = res["results"]["rsum"]

    # 6. cli/train at dp=2; rank 0 alone writes the checkpoint; --resume on both ranks
    writes = []
    real_write = tckpt._write
    tckpt._write = lambda obj, path, retries: writes.append(path) or real_write(obj, path,
                                                                              retries)
    run_dir = os.path.join(work, "cli_dp2")
    argv = ["--config", os.path.join(work, "recipe.json"), "--eval_model_dir",
            os.path.join(work, "oscar"), "--output_dir", run_dir, "--logger_name", run_dir,
            "--mesh_shape", "dp=2", *CLI_DIMS]
    res = train_cli.run(argv + ["--num_epochs", "1"])
    out["cli_best_rsum"] = res["trainer"].best_rsum
    out["cli_steps"] = res["state"].step
    out["cli_layer0"] = res["state"].model.state_dict()[
        "oscar_model.bert.encoder.layer.0.intermediate.dense.weight"].numpy()
    out["cli_writes"] = len(writes)
    again = train_cli.run(argv + ["--num_epochs", "2", "--resume", res["checkpoint"]])
    out["resumed_steps"] = again["state"].step
    out["resumed_params"] = torch.cat([p.detach().reshape(-1)
                                       for p in again["state"].trainable]).numpy()
    out["resume_writes"] = len(writes) - out["cli_writes"]
    tckpt._write = real_write

    # 7. cli/test and cli/search query at dp=2
    test_dir = os.path.join(work, "test_dp2")
    res = test_cli.run(cli_test_argv(work, test_dir) + ["--mesh_shape", "dp=2"])
    out["cli_test_scores"] = res["scores"]
    out["cli_test_rsum"] = res["matching"]["rsum"]
    for direction in ("t2i", "i2t"):
        hits = search_cli.run(search_query_argv(work, direction) + ["--mesh_shape", "dp=2"])
        out[f"cli_search_{direction}"] = hit_rows(hits)

    D.barrier("done")
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} OK")


def scst_step_params(rank: int = 0, mesh_shape: str = "") -> dict:
    """One SCST step (tasks/scst.py) on the whole caption batch, every rank
    the same rows and advantages, from rank 0's weights: the loss, the
    parameters before and after it."""
    from aladin_torch.cli.pretrain import data_parallel, make_optimizer
    from aladin_torch.models.bert_img import BertImgConfig, init_weights
    from aladin_torch.tasks.scst import make_scst_step

    model = _task_model("caption", BertImgConfig(**TASK_CFG))
    init_weights(model, torch.Generator().manual_seed(3 + rank), 0.02)
    mesh = data_parallel(model, mesh_shape, TASK_B, 0, "cpu")[0] if mesh_shape else None
    before = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ids, masks, seg, feats, _, _ = (torch.from_numpy(a) for a in caption_batch())
    rows = ids[:, :CAPTION_A].clone()
    rows[:, 0], rows[::3, 4:] = 2, 0  # CLS first; some rows padded
    adv = torch.from_numpy(np.random.RandomState(13).randn(TASK_B).astype(np.float32))
    opt, _ = make_optimizer(model, 1e-3, 0, 10)
    loss = make_scst_step(model, opt, mask_id=4, pad_id=0, mesh=mesh)(
        rows, adv, ids[:, CAPTION_A:], seg[:, CAPTION_A:], feats, masks)["loss"]
    return {"scst_loss": loss.item(), "scst_before": before.numpy(),
            "scst_after": torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()}


def cli_test_argv(work: str, out_dir: str):
    return ["--config", os.path.join(work, "recipe.json"), "--eval_model_dir",
            os.path.join(work, "oscar"), "--output_dir", out_dir, "--logger_name", out_dir,
            *CLI_DIMS]


def hit_rows(results) -> np.ndarray:
    """(rank, score, image key) of every hit of cli/search query's results."""
    return np.asarray([[h["rank"], h["score"], h["image_key"]] for q in results
                       for h in q["hits"]], dtype=np.float64)


def search_query_argv(work: str, direction: str):
    rows = [a for j in (0, 3, 7) for a in ("--query_index", str(j))]
    return ["query", "--index_dir", os.path.join(work, "index"), "--direction", direction,
            "--k", "5", *rows, "--device", "cpu"]


# ---------------------------------------------------------------------------
# the pytest side
# ---------------------------------------------------------------------------


def _jax_train_inputs():
    """(aladin_tpu model, its config, Flax params, the (8-row) numpy batch)."""
    import dataclasses

    import jax

    from aladin_tpu.config import ExperimentConfig as JaxExperimentConfig
    from aladin_tpu.models.aladin import ALADIN as JaxALADIN
    from tests.test_models import make_batch, small_cfg

    jcfg = JaxExperimentConfig.from_dict(RECIPE)
    jmodel = JaxALADIN(jcfg, dataclasses.replace(small_cfg(), **NO_DROPOUT))
    jbatch = make_batch(np.random.RandomState(0), b=8)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, True)["params"]
    batch = {f: np.asarray(getattr(jbatch, f)) for f in jbatch.__dataclass_fields__}
    return jmodel, jcfg, params, batch


def _write_cli_inputs(work: str) -> None:
    """The recipe (dropout 0, bs 8, embed 32) and a tiny OSCAR directory
    whose config sets the backbone's dropouts to 0, for both cli/train runs."""
    from aladin_torch.models.bert_img import BertImgConfig, BertImgModel

    recipe = json.load(open(os.path.join(REPO, "aladin_torch", "configs",
                                         "alad-alignment-and-matching-distill.json")))
    recipe["model"].update({"embed-size": 32, "dropout": 0.0})
    recipe["training"].update({"bs": 8, "lr": 1e-3})
    with open(os.path.join(work, "recipe.json"), "w") as f:
        json.dump(recipe, f)
    cfg = BertImgConfig(vocab_size=len(SYNTH_VOCAB), hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=128, img_feature_dim=32, **NO_DROPOUT)
    gen = torch.Generator().manual_seed(5)
    model = BertImgModel(cfg)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    oscar = os.path.join(work, "oscar")
    os.makedirs(oscar)
    with open(os.path.join(oscar, "config.json"), "w") as f:
        json.dump(cfg.to_json_dict(), f)
    torch.save({"bert." + k: v for k, v in model.state_dict().items()},
               os.path.join(oscar, "pytorch_model.bin"))
    with open(os.path.join(oscar, "vocab.txt"), "w") as f:
        f.write("\n".join(SYNTH_VOCAB) + "\n")


class Cluster:
    """The two worker processes and, once they end, their results."""

    def __init__(self, work: str):
        self.work = work
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                                        work], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for r in range(WORLD)]
        self._ranks = None

    def ranks(self):
        """[rank 0's results, rank 1's]: waits for the workers once."""
        if self._ranks is None:
            try:
                outs = [p.communicate(timeout=TIMEOUT)[0] for p in self.procs]
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            for r, (p, text) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0 and f"rank {r} OK" in text, \
                    f"rank {r} failed:\n{text[-4000:]}"
            self._ranks = [dict(np.load(os.path.join(self.work, f"rank{r}.npz")))
                           for r in range(WORLD)]
        return self._ranks


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    import jax

    from aladin_torch.io.convert import state_dict_from_flax

    work = str(tmp_path_factory.mktemp("dp"))
    jmodel, jcfg, params, batch = _jax_train_inputs()
    torch.save(state_dict_from_flax(jax.tree.map(np.asarray, params)),
               os.path.join(work, "train_sd.pt"))
    np.savez(os.path.join(work, "train_batch.npz"), **batch)
    _write_cli_inputs(work)
    from aladin_torch.cli import search as search_cli

    search_cli.run(["build", "--index_dir", os.path.join(work, "index"),
                    *cli_test_argv(work, os.path.join(work, "index_run"))])
    c = Cluster(work)
    c.jax_train = (jmodel, jcfg, params, batch)
    yield c
    for p in c.procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def jax_mesh():
    from aladin_tpu.parallel.mesh import create_mesh

    return create_mesh("dp=2")


def test_process_group(cluster):
    """initialize, rank and world size, barrier, all_reduce_metrics (mean,
    sum) equal on both ranks (tests/test_distributed.py's cluster smoke)."""
    for r, res in enumerate(cluster.ranks()):
        assert (int(res["world"]), int(res["rank"]), bool(res["is_main"])) == (2, r, r == 0)
        assert float(res["mean_acc"]) == 1.5 and float(res["mean_n"]) == 15.0
        assert float(res["sum_count"]) == 3.0


@pytest.mark.parametrize("name", ["bf16", "int8", "f32"])
def test_sharded_mrsw_scores(cluster, jax_mesh, name):
    """Equal on both ranks; equal to aladin_tpu's sharded scorer at dp=2 (the
    Pallas kernel in interpret mode; XLA's scorer for f32) and, except int8
    (per-shard scales), to the port's unsharded scorer."""
    import jax.numpy as jnp

    from aladin_torch.ops.alignment import score_all_pairs
    from aladin_torch.ops.kernels.alignment_kernel import mrsw_scores
    from aladin_tpu.parallel.mesh import sharded_mrsw_scores as jax_sharded

    r0, r1 = cluster.ranks()
    got = r0[f"mrsw_{name}"]
    np.testing.assert_array_equal(got, r1[f"mrsw_{name}"])
    ims, caps, il, cl = scoring_inputs()
    assert got.shape == (N_IM, N_IM * CPI)
    dtype = {"bf16": jnp.bfloat16, "int8": jnp.int8, "f32": jnp.bfloat16}[name]
    want = np.asarray(jax_sharded(jax_mesh, ims, caps, il, cl, use_pallas=name != "f32",
                                  interpret=True, compute_dtype=dtype,
                                  small_corpus_fallback=False))
    atol = 1e-5 if name == "int8" else 1e-4
    np.testing.assert_allclose(got, want, atol=atol)
    t = [torch.from_numpy(x) for x in (ims, caps, il, cl)]
    if name == "bf16":
        np.testing.assert_allclose(got, mrsw_scores(*t).numpy(), atol=1e-4)
    elif name == "f32":
        np.testing.assert_allclose(got, score_all_pairs(*t, "MrSw", 128).numpy(), atol=1e-4)


def test_sharded_matching_scores_and_recall(cluster, jax_mesh):
    """The sharded dot scores equal aladin_tpu's at dp=2 and the unsharded
    product; compute_recall_from_scores equals aladin_tpu's on them."""
    from aladin_torch.eval.recall import compute_recall_from_scores
    from aladin_tpu.eval.recall import compute_recall_from_scores as jax_recall
    from aladin_tpu.parallel.mesh import sharded_matching_scores as jax_sharded

    r0, r1 = cluster.ranks()
    got = r0["matching"]
    np.testing.assert_array_equal(got, r1["matching"])
    img_g, cap_g = unit_globals()
    np.testing.assert_allclose(got, np.asarray(jax_sharded(jax_mesh, img_g, cap_g)), atol=1e-5)
    np.testing.assert_allclose(got, img_g @ cap_g.T, atol=1e-5)
    assert compute_recall_from_scores(got) == jax_recall(got)
    assert compute_recall_from_scores(torch.from_numpy(got)) == jax_recall(got)


@pytest.mark.parametrize("direction,rerank", SEARCH_CASES)
def test_sharded_search(cluster, jax_mesh, direction, rerank):
    """Both directions, with and without the rerank, the shortlist (4)
    binding in every shard: indices equal to aladin_tpu's sharded_search at
    dp=2, scores within 1e-4; the same on both ranks."""
    from aladin_tpu.eval.search import build_corpus as jax_build_corpus
    from aladin_tpu.eval.search import sharded_search as jax_sharded_search

    r0, r1 = cluster.ranks()
    key = f"search_{direction}_{rerank}"
    for part in ("scores", "idx"):
        np.testing.assert_array_equal(r0[f"{key}_{part}"], r1[f"{key}_{part}"])
    ims, caps, il, cl = scoring_inputs()
    embs, lens = (ims, il) if direction == "t2i" else (caps, cl)
    q_sets, q_lens = search_queries(direction, ims, caps, il, cl)
    want_s, want_i = jax_sharded_search(jax_mesh, jax_build_corpus(embs, lens), q_sets, q_lens,
                                        direction=direction, k=SEARCH_K,
                                        shortlist=SEARCH_SHORTLIST, rerank=rerank)
    np.testing.assert_array_equal(r0[f"{key}_idx"], want_i)
    np.testing.assert_allclose(r0[f"{key}_scores"], want_s, atol=1e-4)


def test_streaming_matching_mesh(cluster, jax_mesh):
    """The matching mesh sweep with a top-k carry: ranks and top-k equal to
    the solo sweep's and to aladin_tpu's mesh sweep (tests/test_streaming.py
    :70, :81)."""
    from aladin_tpu.eval.streaming import streaming_matching_ranks as jax_ranks

    r0, r1 = cluster.ranks()
    img_g, cap_g = unit_globals()
    j_i2t, j_t2i, (j_v, j_c) = jax_ranks(img_g, cap_g, CPI, cap_block=40, topk=5, mesh=jax_mesh)
    for part, want in (("i2t", j_i2t), ("t2i", j_t2i), ("topc", j_c)):
        got = r0[f"stream_match_mesh_{part}"]
        np.testing.assert_array_equal(got, r1[f"stream_match_mesh_{part}"])
        np.testing.assert_array_equal(got, r0[f"stream_match_solo_{part}"])
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(r0["stream_match_mesh_topv"], np.asarray(j_v), rtol=1e-6)


@pytest.mark.parametrize("kernel", [False, True])
def test_streaming_alignment_mesh(cluster, jax_mesh, kernel):
    """The alignment mesh sweep (f32 score_all_pairs tiles, or the MrSw
    kernel's plain version in bf16, K1's role on the card): ranks equal to
    the solo sweep's; the f32 ones also to aladin_tpu's mesh sweep
    (tests/test_streaming.py:153)."""
    from aladin_tpu.eval.streaming import streaming_alignment_ranks as jax_ranks

    r0, r1 = cluster.ranks()
    ims, caps, il, cl = scoring_inputs()
    if not kernel:
        want = jax_ranks(np.repeat(ims, CPI, axis=0), caps, np.repeat(il, CPI), cl, "MrSw", CPI,
                         cap_block=16, use_pallas=False, mesh=jax_mesh)
    for i, part in enumerate(("i2t", "t2i")):
        got = r0[f"stream_align_{kernel}_mesh_{part}"]
        np.testing.assert_array_equal(got, r1[f"stream_align_{kernel}_mesh_{part}"])
        np.testing.assert_array_equal(got, r0[f"stream_align_{kernel}_solo_{part}"])
        if not kernel:
            np.testing.assert_array_equal(got, np.asarray(want[i]))


def _port_single_step(batch, sd):
    """The port's single-process step on the whole batch: (metrics, params,
    grads by name)."""
    from aladin_torch.config import ExperimentConfig
    from aladin_torch.models.aladin import ALADIN, Batch
    from aladin_torch.models.bert_img import BertImgConfig
    from aladin_torch.train.state import TrainState
    from aladin_torch.train.step import make_loss_fn, make_train_step

    cfg = ExperimentConfig.from_dict(RECIPE)
    tb = Batch(**{f: torch.from_numpy(np.array(batch[f])) for f in Batch.__dataclass_fields__})
    model = ALADIN(cfg, BertImgConfig(**SMALL, **NO_DROPOUT))
    model.load_state_dict(sd, strict=True)
    state = TrainState(cfg, model, steps_per_epoch=10)
    model.train()
    make_loss_fn(model, cfg)(state.aux, tb, 0)[0].backward()
    grads = {n: p.grad.clone() for n, p in state.named_params().items() if p.grad is not None}
    model.zero_grad()
    metrics = make_train_step(model, cfg)(state, tb, 0)
    params = {n: p.detach().clone() for n, p in state.named_params().items()}
    return {k: v.item() for k, v in metrics.items()}, params, grads


def _assert_step_close(got_metrics, got_params, want_metrics, want_params, grads):
    scale = max(float(g.abs().max()) for g in grads.values())
    for k in ("loss", "grad_norm", "alignment_loss", "distillation_loss"):
        np.testing.assert_allclose(got_metrics[k], want_metrics[k], rtol=1e-4, err_msg=k)
    for name, w in want_params.items():
        got = got_params[name]
        live = np.abs(grads[name].numpy()) > 1e-4 * scale if name in grads else np.zeros(
            w.shape, bool)
        np.testing.assert_allclose(got[live], w.numpy()[live], atol=1e-6, err_msg=name)
        assert np.all(np.abs(got - w.numpy()) <= 2 * LR * 1.001), name


def test_dp_step_matches_single_process_and_jax(cluster, jax_mesh):
    """One flagship step at dp=2 over a global batch of 8 (4 rows a rank),
    dropout 0: metrics and params within the step tolerances of the port's
    single-process step on the whole batch and of aladin_tpu's step on a
    dp=2 mesh from the same converted weights; equal on both ranks."""
    import jax
    import jax.numpy as jnp

    from aladin_torch.io.convert import params_from_flax
    from aladin_tpu.data.pipeline import batch_from_numpy
    from aladin_tpu.parallel.sharding import batch_sharding, replicated
    from aladin_tpu.train.state import create_train_state
    from aladin_tpu.train.step import make_train_step as jax_make_train_step

    r0, r1 = cluster.ranks()
    metrics = {k[len("step_"):]: float(v) for k, v in r0.items()
               if k.startswith("step_") and not k.startswith("step_param.")}
    params = {k[len("step_param."):]: v for k, v in r0.items() if k.startswith("step_param.")}
    for k in r0:
        if k.startswith("step_"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)

    jmodel, jcfg, jparams, batch = cluster.jax_train
    sd = torch.load(os.path.join(cluster.work, "train_sd.pt"), weights_only=True)
    want_m, want_p, grads = _port_single_step(batch, sd)
    _assert_step_close(metrics, params, want_m, want_p, grads)

    jstate = create_train_state(jcfg, jparams, steps_per_epoch=10)
    jstate = jax.device_put(jstate, replicated(jax_mesh))
    new_state, jm = jax_make_train_step(jmodel, jcfg)(
        jstate, batch_from_numpy(batch, batch_sharding(jax_mesh)), jnp.int32(0),
        jax.random.PRNGKey(1))
    jax_p = params_from_flax(jax.tree.map(np.asarray, new_state.params))
    _assert_step_close(metrics, params, {k: float(v) for k, v in jm.items()}, jax_p, grads)


@pytest.mark.parametrize("task", sorted(TASK_STEPS))
def test_dp_task_steps_match_one_process(cluster, task):
    """OSCAR+ pretraining (its MLM denominator the global masked count), the
    VQA classifier with the kl loss (over the global B), captioning with
    drop-worst 0.3 (the global batch's per-token losses sorted together)
    and the ce pair step (over the global rows), 2 steps at
    dp=2 from rank 0's broadcast weights against one process on the whole
    batch: the losses within 1e-5 relative, the parameters within 1e-6
    where each step's gradient is live and within 2 lr elsewhere (Adam turns
    rounding noise of a near-zero gradient into an update of up to lr);
    equal on both ranks."""
    r0, r1 = cluster.ranks()
    want_l, want_p, grads = run_task_steps(task)
    for k in r0:
        if k.startswith(task + "_"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_allclose(r0[f"{task}_losses"], want_l, rtol=1e-5)
    scale = max(float(g.abs().max()) for gs in grads for g in gs.values())
    for name, w in want_p.items():
        got = r0[f"{task}_param.{name}"]
        live = np.all([np.abs(gs[name].numpy()) > 1e-4 * scale for gs in grads], axis=0)
        np.testing.assert_allclose(got[live], w.numpy()[live], atol=1e-6, err_msg=name)
        assert np.all(np.abs(got - w.numpy()) <= 2 * LR * 1.001), name


def test_task_clis_run_at_dp2(cluster):
    """cli/pretrain and cli/classify --mesh_shape dp=2 --synthetic: finite
    losses and equal parameters on both ranks; rank 0 wrote the checkpoint
    (it loads strictly) and the test predictions."""
    from aladin_torch.models.bert_img import BertImgConfig
    from aladin_torch.tasks.pretraining import BertImgForPreTraining

    r0, r1 = cluster.ranks()
    for cli in ("pretrain", "classify"):
        assert np.all(np.isfinite(r0[f"{cli}_cli_losses"]))
        np.testing.assert_array_equal(r0[f"{cli}_cli_losses"], r1[f"{cli}_cli_losses"])
        np.testing.assert_array_equal(r0[f"{cli}_cli_params"], r1[f"{cli}_cli_params"])
    ckpt = torch.load(str(r0["pretrain_cli_ckpt"]), map_location="cpu", weights_only=True)
    vocab = ckpt["model"]["bert.embeddings.word_embeddings.weight"].shape[0]
    model = BertImgForPreTraining(BertImgConfig(vocab_size=vocab, hidden_size=64,
                                                num_hidden_layers=2, num_attention_heads=4,
                                                intermediate_size=128,
                                                max_position_embeddings=128, img_feature_dim=16))
    model.load_state_dict(ckpt["model"], strict=True)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()
    np.testing.assert_array_equal(flat, r0["pretrain_cli_params"])
    with open(str(r0["classify_cli_results"])) as f:
        assert len(json.load(f)) == 32


def test_dp_scst_step_keeps_ranks_equal(cluster):
    """One SCST step at dp=2 (each rank the whole batch, the gradients
    averaged): the parameters moved, are equal on both ranks bit for bit,
    and equal one process's step."""
    r0, r1 = cluster.ranks()
    for k in ("scst_loss", "scst_before", "scst_after"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert np.any(r0["scst_after"] != r0["scst_before"])
    want = scst_step_params()
    np.testing.assert_array_equal(r0["scst_before"], want["scst_before"])
    assert float(r0["scst_loss"]) == pytest.approx(want["scst_loss"], rel=1e-6)
    np.testing.assert_allclose(r0["scst_after"], want["scst_after"], atol=1e-6)


def test_caption_and_pair_clis_run_at_dp2(cluster):
    """cli/captioning (one CE epoch, one SCST epoch, greedy decode) and
    cli/retrieval_oscar --mesh_shape dp=2 --synthetic: finite losses, and
    the parameters, captions and R@K equal on both ranks."""
    r0, r1 = cluster.ranks()
    for cli in ("captioning", "retrieval_oscar"):
        assert np.all(np.isfinite(r0[f"{cli}_cli_losses"]))
        for part in ("losses", "params"):
            np.testing.assert_array_equal(r0[f"{cli}_cli_{part}"], r1[f"{cli}_cli_{part}"])
    np.testing.assert_array_equal(r0["captioning_cli_preds"], r1["captioning_cli_preds"])
    assert float(r0["retrieval_oscar_cli_rsum"]) == float(r1["retrieval_oscar_cli_rsum"])


def test_dp_params_equal_across_ranks_after_three_steps(cluster):
    """Three steps at dropout 0.1 (each rank its own masks): the parameters
    moved and are equal on both ranks bit for bit."""
    r0, r1 = cluster.ranks()
    assert bool(r0["dropout_params_moved"])
    np.testing.assert_array_equal(r0["dropout_params_after_3"], r1["dropout_params_after_3"])


def test_dropout_masks_differ_across_ranks(cluster):
    """With the rank folded into the generators, the same rows on both ranks
    at dropout 0.1 give other losses; from one generator state, the same."""
    r0, r1 = cluster.ranks()
    assert float(r0["dropout_loss_folded"]) != float(r1["dropout_loss_folded"])
    assert float(r0["dropout_loss_same_seed"]) == float(r1["dropout_loss_same_seed"])


def test_train_cli_dp2_matches_dp1(cluster, tmp_path):
    """cli/train --mesh_shape dp=2 for one epoch against dp=1 of the same
    seed, dropout 0: best rsum within 2.6, the layer-0 intermediate weight
    within 2e-4 (tests/test_e2e_cli.py's bounds)."""
    from aladin_torch.cli import train as train_cli

    r0, r1 = cluster.ranks()
    run = str(tmp_path / "dp1")
    solo = train_cli.run(["--config", os.path.join(cluster.work, "recipe.json"),
                          "--eval_model_dir", os.path.join(cluster.work, "oscar"),
                          "--output_dir", run, "--logger_name", run, "--mesh_shape", "dp=1",
                          "--num_epochs", "1", *CLI_DIMS])
    assert int(r0["cli_steps"]) == int(r1["cli_steps"]) == solo["state"].step > 0
    assert abs(float(r0["cli_best_rsum"]) - solo["trainer"].best_rsum) <= 2.6
    w = solo["state"].model.state_dict()[
        "oscar_model.bert.encoder.layer.0.intermediate.dense.weight"].numpy()
    np.testing.assert_allclose(r0["cli_layer0"], w, atol=2e-4)
    np.testing.assert_array_equal(r0["cli_layer0"], r1["cli_layer0"])


def test_rank0_alone_writes_and_resume_reads_on_both(cluster):
    """Rank 0 wrote every checkpoint file, rank 1 none; --resume on both
    ranks continued the step count and ended with equal parameters."""
    r0, r1 = cluster.ranks()
    assert int(r0["cli_writes"]) >= 1 and int(r0["resume_writes"]) >= 1
    assert int(r1["cli_writes"]) == int(r1["resume_writes"]) == 0
    assert int(r0["resumed_steps"]) == int(r1["resumed_steps"]) == 2 * int(r0["cli_steps"])
    np.testing.assert_array_equal(r0["resumed_params"], r1["resumed_params"])


def test_cli_test_dp2_equals_dp1(cluster, tmp_path):
    """cli/test --mesh_shape dp=2 (every rank encodes; the alignment head
    scored through sharded_mrsw_scores) gives the dp=1 run's scores and
    R@K on both ranks."""
    from aladin_torch.cli import test as test_cli

    r0, r1 = cluster.ranks()
    solo = test_cli.run(cli_test_argv(cluster.work, str(tmp_path)) + ["--mesh_shape", "dp=1"])
    np.testing.assert_array_equal(r0["cli_test_scores"], r1["cli_test_scores"])
    np.testing.assert_allclose(r0["cli_test_scores"], solo["scores"], atol=1e-6)
    assert float(r0["cli_test_rsum"]) == float(r1["cli_test_rsum"]) == solo["matching"]["rsum"]


@pytest.mark.parametrize("direction", ["t2i", "i2t"])
def test_cli_search_query_dp2_equals_one_process(cluster, direction):
    """cli/search query --mesh_shape dp=2 (sharded_search over the index,
    a shortlist covering each shard) returns the one-process hits."""
    from aladin_torch.cli import search as search_cli

    r0, r1 = cluster.ranks()
    hits = search_cli.run(search_query_argv(cluster.work, direction))
    want = hit_rows(hits)
    np.testing.assert_array_equal(r0[f"cli_search_{direction}"], r1[f"cli_search_{direction}"])
    np.testing.assert_allclose(r0[f"cli_search_{direction}"], want, atol=1e-4)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
