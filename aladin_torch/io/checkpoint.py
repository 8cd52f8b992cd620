"""Checkpoint loading for evaluation (mirrors the read side of
aladin_tpu/io/checkpoint.py for the released ``.pth.tar`` format).

Orbax directories, saving, resume and teacher loading belong to the
training slice and are not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

from torch import nn

from aladin_torch.io.convert import load_aladin_checkpoint


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(payload, embedded experiment config dict) of a ``.pth.tar`` file;
    payload = {"model": state dict, "step", "epoch", "format"}."""
    path = os.path.abspath(path)
    if not os.path.isfile(path):
        raise NotImplementedError(
            f"{path}: only reference .pth.tar files load in the port; orbax checkpoint "
            "directories are a JAX format (ROADMAP.md, queue 1: checkpoints)")
    sd, config, meta = load_aladin_checkpoint(path)
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
