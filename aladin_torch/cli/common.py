"""Shared CLI plumbing: flags, model construction, data wiring (mirrors
aladin_tpu/cli/common.py for evaluation and training)."""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
from typing import Optional

import torch

from aladin_torch.config import DataArgs, ExperimentConfig
from aladin_torch.data.dataset import RetrievalDataset, make_synthetic_dataset
from aladin_torch.data.pipeline import BatchLoader
from aladin_torch.data.tokenizer import BertWordPieceTokenizer
from aladin_torch.eval.dcg import DCG
from aladin_torch.io.checkpoint import load_state_dict_report
from aladin_torch.io.convert import load_oscar_checkpoint
from aladin_torch.models.aladin import ALADIN
from aladin_torch.models.bert_img import BertImgConfig
from aladin_torch.parallel.distributed import barrier, get_world_size, is_main_process, rank_seed
from aladin_torch.parallel.mesh import Mesh, broadcast_, create_mesh, mesh_axes
from aladin_torch.parallel.sharding import check_tp, shard_module_

logger = logging.getLogger("vlpretrain")


def add_shared_flags(p: argparse.ArgumentParser) -> None:
    """aladin_tpu's flag surface, plus ``--device``."""
    p.add_argument("--data_dir", default="datasets/coco_ir")
    p.add_argument("--img_feat_file", default="datasets/coco_ir/features.tsv")
    p.add_argument("--eval_model_dir", default="", help="OSCAR/VinVL checkpoint dir (backbone + vocab)")
    p.add_argument("--output_dir", default="output/")
    p.add_argument("--logger_name", default="runs/runX")
    p.add_argument("--max_seq_length", type=int, default=70)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--img_feature_dim", type=int, default=2054)
    p.add_argument("--img_feature_type", default="frcnn")
    p.add_argument("--use_img_layernorm", type=int, default=1)
    p.add_argument("--img_layer_norm_eps", type=float, default=1e-12)
    p.add_argument("--add_od_labels", action="store_true", default=False)
    p.add_argument("--od_label_type", default="vg")
    p.add_argument("--att_mask_type", default="CLR")
    p.add_argument("--do_lower_case", action="store_true", default=True)
    p.add_argument("--num_captions_per_img_train", type=int, default=5)
    p.add_argument("--num_captions_per_img_val", type=int, default=5)
    p.add_argument("--eval_img_keys_file", default="")
    p.add_argument("--eval_caption_index_file", default="")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=88)
    p.add_argument("--num_epochs", type=int, default=20)
    p.add_argument("--log_step", type=int, default=10)
    p.add_argument("--val_step", type=int, default=500)
    p.add_argument("--resume", default="")
    p.add_argument("--load-teacher-model", dest="load_teacher_model", default="")
    p.add_argument("--reinitialize-scheduler", dest="reinitialize_scheduler", action="store_true")
    p.add_argument("--config", default="")
    p.add_argument("--mesh_shape", default="dp=-1",
                   help="dp=N,tp=M under torchrun (one process a GPU, N x M ranks); dp=-1 = "
                        "every rank; cli/train shards the model over tp (Megatron), "
                        "cli/test and cli/search shard only the corpus scoring")
    p.add_argument("--ndcg", action="store_true", default=False,
                   help="NDCG@25 from the relevance matrices on disk (<data_dir>/relevances "
                        "or <dataset.data>/<dataset.name>/relevances)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8"],
                   help="bfloat16/float32: encoder dtype. int8: the encoder stays bfloat16 and "
                        "the alignment scoring kernel runs on int8 operands")
    p.add_argument("--int8_encoder", action="store_true",
                   help="run the encoder's QKV and FFN-up projections as W8A8 int8 (kernel "
                        "K4); evaluation/serving only (cli/test)")
    p.add_argument("--synthetic", action="store_true",
                   help="build a tiny on-disk synthetic dataset + random backbone")
    p.add_argument("--profile_dir", default="",
                   help="cli/train: write a torch.profiler Chrome trace (trace.json) of "
                        "--profile_steps train steps, from the second dispatch, here")
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="cli/train: K train steps a dispatch, one CUDA graph of K steps on "
                        "the card (the same result as K single steps); log/val cadences fire "
                        "at window boundaries")
    add_device_flag(p)


def add_hidden_act_flag(p: argparse.ArgumentParser) -> None:
    """--hidden_act for drivers that build a BertImgConfig directly (the
    OSCAR task drivers; the flagship trainer reads model.hidden-act from its
    recipe instead)."""
    p.add_argument("--hidden_act", default="gelu", choices=["gelu", "gelu_tanh"],
                   help="backbone FFN activation; gelu_tanh = the tanh approximation (not "
                        "bit-compatible with erf-trained checkpoints)")


def add_device_flag(p: argparse.ArgumentParser) -> None:
    """--device, with CUDA as the default."""
    p.add_argument("--device", default="cuda",
                   help="torch device; entry points need CUDA unless this is 'cpu'")


def task_tokenizer(eval_model_dir: str) -> BertWordPieceTokenizer:
    """The OSCAR task drivers' tokenizer: the vocab of ``eval_model_dir``
    when given, else the synthetic one."""
    if eval_model_dir:
        return BertWordPieceTokenizer.from_pretrained(eval_model_dir)
    return build_tokenizer(DataArgs())


def to_data_args(ns: argparse.Namespace) -> DataArgs:
    keep = {f.name for f in dataclasses.fields(DataArgs)}
    return DataArgs(**{k: v for k, v in vars(ns).items() if k in keep})


def restore_training_settings(args: DataArgs) -> DataArgs:
    """Override data flags from the OSCAR checkpoint's training_args.bin
    (a pickled namespace: read only checkpoints you trust)."""
    bin_path = os.path.join(args.eval_model_dir, "training_args.bin")
    if not (args.eval_model_dir and os.path.exists(bin_path)):
        return args
    train_args = torch.load(bin_path, map_location="cpu", weights_only=False)
    for param in ("do_lower_case", "img_feature_type", "add_od_labels",
                  "od_label_type", "use_img_layernorm", "img_layer_norm_eps"):
        if hasattr(train_args, param):
            setattr(args, param, getattr(train_args, param))
    return args


def build_model(cfg: ExperimentConfig, args: DataArgs, device: torch.device,
                **bert_knobs) -> ALADIN:
    """ALADIN in eval mode on ``device`` for evaluation: the encoder's
    parameters in f32 for ``--compute_dtype float32`` and in bf16 otherwise
    (the W8A8 layers of ``--int8_encoder`` keep theirs in f32).
    ``bert_knobs``: further BertImgConfig fields (``fused_layernorm``...)."""
    model = _build_aladin(cfg, args, **bert_knobs)
    return model.to(device=device, dtype=compute_dtype_of(args)).eval()


def build_train_model(cfg: ExperimentConfig, args: DataArgs, device: torch.device) -> ALADIN:
    """ALADIN with f32 parameters in train mode on ``device``: the train
    step computes in ``compute_dtype_of(args)`` under autocast."""
    return _build_aladin(cfg, args).to(device=device).train()


def compute_dtype_of(args: DataArgs) -> torch.dtype:
    """The encoder's compute dtype: f32 for ``--compute_dtype float32``,
    bf16 otherwise (int8 quantizes only the alignment scoring)."""
    return torch.float32 if args.compute_dtype == "float32" else torch.bfloat16


def _build_aladin(cfg: ExperimentConfig, args: DataArgs, **bert_knobs) -> ALADIN:
    """ALADIN on the CPU with f32 parameters: heads random from a generator
    seeded with ``args.seed``, the backbone from the OSCAR directory when
    given; ``--int8_encoder`` sets ``quant_matmuls`` in every branch."""
    if args.int8_encoder:
        bert_knobs = {"quant_matmuls": True, **bert_knobs}
    backbone_sd = None
    if args.eval_model_dir and os.path.isdir(args.eval_model_dir):
        backbone_sd, bert_cfg = load_oscar_checkpoint(args.eval_model_dir)
        # the checkpoint's activation wins unless the recipe opts into gelu-tanh
        act = cfg.model.hidden_act if cfg.model.hidden_act != "gelu" else bert_cfg.hidden_act
        if act != cfg.model.hidden_act:
            logger.warning("hidden-act: checkpoint declares %r, config has %r; following the "
                           "checkpoint", bert_cfg.hidden_act, cfg.model.hidden_act)
        bert_cfg = dataclasses.replace(bert_cfg, hidden_act=act, **bert_knobs)
        if cfg.model.embed_size != bert_cfg.hidden_size:
            logger.warning("embed-size %d != checkpoint hidden %d; using the checkpoint's",
                           cfg.model.embed_size, bert_cfg.hidden_size)
            d = cfg.to_dict()
            d["model"]["embed-size"] = bert_cfg.hidden_size
            cfg = ExperimentConfig.from_dict(d)
    elif args.synthetic:  # tiny backbone for smoke runs
        bert_cfg = BertImgConfig(
            vocab_size=512, hidden_size=cfg.model.embed_size, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=2 * cfg.model.embed_size,
            max_position_embeddings=128, img_feature_dim=args.img_feature_dim,
            hidden_act=cfg.model.hidden_act, **bert_knobs)
    else:
        bert_cfg = BertImgConfig(img_feature_dim=args.img_feature_dim,
                                 hidden_act=cfg.model.hidden_act, **bert_knobs)
    model = ALADIN(cfg, bert_cfg)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model.oscar_model.bert.seed_generator.manual_seed(args.seed)
    if backbone_sd is not None:
        stats = load_state_dict_report(model.oscar_model.bert, backbone_sd)
        if stats["missing"]:
            raise ValueError(f"{args.eval_model_dir}: backbone tensors missing from "
                             f"pytorch_model.bin: {stats['missing'][:8]}")
    return model


def build_tokenizer(args: DataArgs) -> BertWordPieceTokenizer:
    if args.eval_model_dir and os.path.isdir(args.eval_model_dir):
        return BertWordPieceTokenizer.from_pretrained(args.eval_model_dir,
                                                      do_lower_case=args.do_lower_case)
    # the synthetic vocab, written to a temporary file so that the C++
    # WordPiece path engages in synthetic runs too (it reads the file whole
    # when it is created)
    base = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words = ["a", "photo", "of", "the", "dog", "cat", "car", "tree", "person",
             "boat", "bird", "house", "number"] + [str(i) for i in range(10)]
    with tempfile.NamedTemporaryFile("w", suffix=".vocab.txt", delete=False) as f:
        f.write("\n".join(base + words) + "\n")
    try:
        return BertWordPieceTokenizer({t: i for i, t in enumerate(base + words)},
                                      do_lower_case=True, vocab_file=f.name)
    finally:
        os.unlink(f.name)


def prepare_synthetic(args: DataArgs, n_images: int = 8) -> DataArgs:
    """Write the synthetic corpus under ``<output_dir>/synthetic_coco_ir``
    (the main process writes it, every rank waits for it) and point
    ``args`` at it."""
    root = os.path.join(args.output_dir, "synthetic_coco_ir")
    if is_main_process():
        make_synthetic_dataset(root, n_images=n_images, feat_dim=args.img_feature_dim)
    barrier("synthetic")
    args.data_dir = root
    args.img_feat_file = os.path.join(root, "features.tsv")
    args.add_od_labels = True
    return args


def build_loaders(tokenizer, args: DataArgs, cfg: ExperimentConfig, device,
                  train_split: str = "train", val_split: str = "minival"):
    """(train loader, shuffled, whole batches; validation loader, in order).
    The validation set is built with is_train=True, as the reference does."""
    bs = cfg.training.bs
    train_ds = RetrievalDataset(tokenizer, args, train_split, is_train=True)
    val_ds = RetrievalDataset(tokenizer, args, val_split, is_train=True)
    train_loader = BatchLoader(train_ds, bs, shuffle=True, seed=args.seed, device=device,
                               num_threads=args.num_workers)
    val_loader = BatchLoader(val_ds, bs, shuffle=False, drop_last=False, device=device,
                             num_threads=args.num_workers)
    return train_loader, val_loader


def build_ndcg_scorer(cfg: ExperimentConfig, args: DataArgs, split: str, n_queries: int):
    """A DCG scorer over whichever relevance matrices exist on disk, else
    None: ``<data_dir>/relevances`` first, then the config's
    ``<dataset.data>/<dataset.name>/relevances``; files
    ``{dataset}-{split}-{rougeL,spice}.npy``, raw float32 (n_queries,
    n_images), methods in (rougeL, spice) order."""
    for rel_dir in (os.path.join(args.data_dir, "relevances"),
                    os.path.join(cfg.dataset.data, cfg.dataset.name, "relevances")):
        methods = [m for m in ("rougeL", "spice") if os.path.exists(
            os.path.join(rel_dir, f"{cfg.dataset.name}-{split}-{m}.npy"))]
        if methods:
            return DCG(cfg, n_queries, split, relevance_methods=methods, rel_dir=rel_dir)
    return None


def maybe_create_mesh(mesh_shape: str, device, model=None) -> Optional[Mesh]:
    """--mesh_shape -> a Mesh over the process group when it spans more than
    one rank, else None (one rank needs no mesh). A spec that asks for
    another number of ranks than the group has raises; with ``model`` (the
    one the mesh will shard), so does a tp that does not divide its head
    counts, before any group is formed."""
    spec = mesh_shape or "dp=-1"
    if model is not None:
        check_tp(model, mesh_axes(spec, get_world_size()).get("tp", 1))
    mesh = create_mesh(spec, device)
    return mesh if mesh.size > 1 else None


def shard_state_and_loaders(state, mesh: Mesh, cfg: ExperimentConfig, seed: int,
                            train_loader: BatchLoader):
    """Placement on a (dp, tp) mesh: rank 0's parameters, buffers, aux
    learnables and optimizer state on every rank (one broadcast each, full
    tensors), then each rank's tp slice of the model and its Adam moments
    (``parallel/sharding.py::shard_module_``), the train loader yielding
    this rank's dp rows of each global batch, and the dp index folded into
    the dropout generators (the CUDA / CPU default generators and the K2
    seed generator): no two dp ranks draw the same masks, and the tp ranks
    of a dp group draw the same ones on their replicated activations.
    Returns the state."""
    dp = mesh.dp
    if cfg.training.bs % dp:
        raise ValueError(f"batch size {cfg.training.bs} must be divisible by dp={dp}")
    opt_tensors = [v for st in state.optimizer.state.values() for v in st.values()
                   if torch.is_tensor(v)]
    broadcast_(mesh, [*state.model.state_dict().values(), *state.aux.values(), *opt_tensors])
    shard_module_(state.model, mesh, state.optimizer)
    state.mesh = mesh
    train_loader.shard(mesh.dp_index, dp)
    folded = rank_seed(seed, mesh.dp_index)
    torch.manual_seed(folded)
    state.model.oscar_model.bert.seed_generator.manual_seed(folded)
    return state
