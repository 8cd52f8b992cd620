"""Corpus encoding (mirrors aladin_tpu/eval/encode.py).

Buffers are (N, buffer_len, D) host arrays with the per-token set and
sequence embeddings written from position 0 and THE GLOBAL MATCHING
EMBEDDING OVERWRITING position 0 (the reference's I-CLS/T-CLS packing; safe
because alignment scoring strips position 0 on both sides).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from aladin_torch.utils.logging import AverageMeter, LogCollector, setup_logger


def encode_data(model, loader, buffer_len: Optional[int] = None, log_step: int = 10,
                logger=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (img_embs (N, S, D), cap_embs (N, S, D), img_lens, cap_lens).
    ``model``: an ALADIN module (run in eval mode) or an eval step of
    train/step.py::make_eval_step."""
    logger = logger or setup_logger()
    batch_time = AverageMeter()
    collector = LogCollector()
    if isinstance(model, nn.Module):
        model.eval()

    img_embs = cap_embs = None
    img_lens, cap_lens = [], []
    ptr = 0
    n = len(loader.dataset)
    end = time.time()
    for i, batch in enumerate(loader.epoch(0)):
        with torch.inference_mode():
            out = model(batch)
        img_set = out.img_set.cpu().numpy()
        cap_seq = out.cap_seq.cpu().numpy()
        img_glob = out.img_global.cpu().numpy()
        cap_glob = out.cap_global.cpu().numpy()
        b = min(img_set.shape[0], n - ptr)  # the final batch wraps; drop the wrap

        if img_embs is None:
            s = buffer_len or (max(img_set.shape[1], cap_seq.shape[1]) + 1)
            img_embs = np.zeros((n, s, img_set.shape[2]), np.float32)
            cap_embs = np.zeros((n, s, cap_seq.shape[2]), np.float32)
        wide = max(img_set.shape[1], cap_seq.shape[1])
        if wide > img_embs.shape[1]:  # a length-trimmed batch can be wider later
            grow = wide - img_embs.shape[1]
            img_embs = np.pad(img_embs, ((0, 0), (0, grow), (0, 0)))
            cap_embs = np.pad(cap_embs, ((0, 0), (0, grow), (0, 0)))

        img_embs[ptr:ptr + b, :img_set.shape[1]] = img_set[:b]
        cap_embs[ptr:ptr + b, :cap_seq.shape[1]] = cap_seq[:b]
        img_embs[ptr:ptr + b, 0] = img_glob[:b]
        cap_embs[ptr:ptr + b, 0] = cap_glob[:b]
        img_lens.extend(out.img_len.cpu().tolist()[:b])
        cap_lens.extend(out.cap_len.cpu().tolist()[:b])
        ptr += b

        batch_time.update(time.time() - end)
        end = time.time()
        if i % log_step == 0:
            logger.info(f"Encode [{i}/{len(loader)}] {collector} time {batch_time}")

    return (img_embs[:ptr], cap_embs[:ptr], np.asarray(img_lens[:ptr], np.int32),
            np.asarray(cap_lens[:ptr], np.int32))
