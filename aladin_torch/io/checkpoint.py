"""Checkpoints as ``.pth.tar`` files in the reference's dict layout (mirrors
aladin_tpu/io/checkpoint.py; orbax directories are a JAX format and stay
out).

A file is {epoch, model, optimizer, scheduler, opt, config, Eiters} with the
model's state dict under ``img_txt_enc.`` (so aladin_tpu's
``load_checkpoint`` and the reference code read the weights), the torch Adam
state under ``optimizer``, the closed-form schedule's step under
``scheduler``, and three additions: ``aux`` (the auto loss weights / mse
affine), ``best_rsum`` and ``schedule_offset`` (``TrainState``'s: the step
at which a weights-only resume restarted the optimizer and its schedule;
files without it read 0).

  * ``save_checkpoint`` writes ``<dir>/checkpoint.pth.tar`` through a
    temporary file swapped in atomically (retrying IO failures), then copies
    it to ``model_best_rsum.pth.tar`` / ``model_best_ndcgspice.pth.tar`` on
    a new best of either gate; in a data-parallel run only the main process
    writes (the state is the same on every rank), the others wait at the
    Trainer's barrier and, on ``--resume``, read the same file;
  * ``resume_state`` restores model, aux, optimizer and step from such a
    file; a released reference file restores the weights only;
  * ``load_teacher_params`` is the non-strict weights-only load, with a
    report of what matched;
  * ``save_task_checkpoint`` writes the OSCAR task drivers' files
    ({"model", "iteration"}, cli/pretrain.py).
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from aladin_torch.io.convert import load_aladin_checkpoint
from aladin_torch.parallel.distributed import is_main_process

PREFIX = "img_txt_enc."


def _check_file(path: str) -> str:
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        raise NotImplementedError(
            f"{path}: only .pth.tar files load in the port; orbax checkpoint "
            "directories are a JAX format (ROADMAP.md, queue 1, item 4)")
    return path


def _read(path: str) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """(the whole checkpoint dict, the model state dict without its prefix).
    The file holds pickled options: load only files you trust."""
    ckpt = torch.load(_check_file(path), map_location="cpu", weights_only=False)
    return ckpt, {k[len(PREFIX):]: v for k, v in ckpt["model"].items() if k.startswith(PREFIX)}


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(payload, embedded experiment config dict) of a ``.pth.tar`` file;
    payload = {"model": state dict, "step", "epoch", "format"}."""
    sd, config, meta = load_aladin_checkpoint(_check_file(path))
    payload = {"model": sd, "step": int(meta["Eiters"]), "epoch": int(meta["epoch"]),
               "format": "pytorch"}
    return payload, config


def load_state_dict_report(model: nn.Module, sd: Dict[str, Any]) -> Dict[str, Any]:
    """Non-strict load (the reference loads with strict=False) that reports
    coverage: {"matched": n, "missing": [...], "unused": [...]}. Raises
    when a tensor's shape disagrees or nothing matched."""
    own = model.state_dict()
    matched = [k for k in sd if k in own]
    for k in matched:
        if tuple(sd[k].shape) != tuple(own[k].shape):
            raise ValueError(f"checkpoint tensor {k}: shape {tuple(sd[k].shape)}, "
                             f"model expects {tuple(own[k].shape)}")
    if not matched:
        raise ValueError("no checkpoint tensor matched the model")
    model.load_state_dict({k: sd[k] for k in matched}, strict=False)
    return {"matched": len(matched), "missing": sorted(set(own) - set(matched)),
            "unused": sorted(set(sd) - set(own))}


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _write(obj, path: str, retries: int) -> None:
    """torch.save to a temporary sibling, then swap it in: the old file
    stays the resume point until the new one is whole."""
    tmp = path + ".tmp"
    for attempt in range(retries):
        try:
            torch.save(obj, tmp)
            break
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(min(2 ** attempt, 30))
    os.replace(tmp, path)


def save_task_checkpoint(path: str, model: nn.Module, iteration: int) -> None:
    """An OSCAR task driver's checkpoint: {"model": the state dict on the
    CPU, "iteration": n} at ``path``, swapped in atomically."""
    _write({"model": _cpu(model.state_dict()), "iteration": int(iteration)}, path, retries=3)


def save_checkpoint(out_dir: str, state, epoch: int, config_dict: Dict[str, Any],
                    best_rsum: float, is_best_rsum: bool = False,
                    opt: Optional[Dict[str, Any]] = None, name: str = "checkpoint",
                    retries: int = 10, is_best_ndcgspice: bool = False) -> str:
    """Write ``<out_dir>/<name>.pth.tar``; copy it to
    ``model_best_rsum.pth.tar`` when ``is_best_rsum`` and to
    ``model_best_ndcgspice.pth.tar`` when ``is_best_ndcgspice``. Returns the
    path; a process other than the main one writes nothing."""
    path = os.path.abspath(os.path.join(out_dir, f"{name}.pth.tar"))
    if not is_main_process():
        return path
    os.makedirs(out_dir, exist_ok=True)
    ckpt = {
        "epoch": int(epoch),
        "model": {PREFIX + k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer": _cpu(state.optimizer_state_dict()),
        "scheduler": {"step": int(state.step)},  # the schedule is closed-form in the step
        "opt": opt,
        "config": config_dict,
        "Eiters": int(state.step),
        "aux": {k: v.detach().cpu() for k, v in state.aux.items()},
        "best_rsum": float(best_rsum),
        "schedule_offset": int(state.schedule_offset),
    }
    _write(ckpt, path, retries)
    for flag, tag in ((is_best_rsum, "model_best_rsum"),
                      (is_best_ndcgspice, "model_best_ndcgspice")):
        if flag:
            best = os.path.join(out_dir, f"{tag}.pth.tar")
            shutil.copyfile(path, best + ".tmp")
            os.replace(best + ".tmp", best)
    return path


def _load_aux(state, aux: Dict[str, torch.Tensor]) -> None:
    with torch.no_grad():
        for k, v in aux.items():
            if k in state.aux and tuple(v.shape) == tuple(state.aux[k].shape):
                state.aux[k].copy_(v)


def resume_state(state, path: str):
    """Full resume from a file ``save_checkpoint`` wrote: weights, aux,
    optimizer state, step and schedule offset. Returns (state, start_epoch,
    best_rsum).

    A released reference ``.pth.tar`` (no port optimizer state) restores
    the weights non-strictly, with epoch and Eiters; the optimizer restarts
    fresh, with a warning, and so does its schedule (the offset becomes
    Eiters), as aladin_tpu's fresh optax state restarts its count."""
    ckpt, sd = _read(path)
    optim = ckpt.get("optimizer") or {}
    full = "aux" in ckpt and "state" in optim
    if full:
        state.model.load_state_dict(sd, strict=True)
        _load_aux(state, ckpt["aux"])
        try:
            state.load_optimizer_state_dict(optim)
        except ValueError as e:
            raise ValueError(f"{path}: the optimizer state does not match the current train "
                             f"state (freeze-teran or the loss set changed since save?): {e}")
    else:
        stats = load_state_dict_report(state.model, sd)
        logging.getLogger("vlpretrain").warning(
            "resuming from a reference checkpoint: %d tensors loaded (%d missing, %d unused); "
            "the optimizer state restarts fresh", stats["matched"], len(stats["missing"]),
            len(stats["unused"]))
    state.step = int(ckpt.get("Eiters", 0))
    state.schedule_offset = int(ckpt.get("schedule_offset", 0)) if full else state.step
    return state, int(ckpt.get("epoch", 0)), float(ckpt.get("best_rsum", 0.0))


def load_teacher_params(state, path: str) -> Dict[str, Any]:
    """Weights-only non-strict load into ``state`` (the reference's
    load_state_dict(strict=False)): every tensor present in both with the
    same shape is copied, the rest keeps its value. Returns
    {"matched": n, "missing": [...], "unused": [...]}; a shape mismatch
    lands in both lists."""
    ckpt, sd = _read(path)
    own = state.model.state_dict()
    take = {k: v for k, v in sd.items() if k in own and tuple(v.shape) == tuple(own[k].shape)}
    state.model.load_state_dict(take, strict=False)
    _load_aux(state, ckpt.get("aux") or {})
    return {"matched": len(take), "missing": sorted(set(own) - set(take)),
            "unused": sorted(set(sd) - set(take))}
