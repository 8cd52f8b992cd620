"""The training orchestrator: epochs, in-loop validation, checkpointing
(mirrors aladin_tpu/train/loop.py for one step per dispatch on one device).

  * per step: the train step; every ``log_step`` steps the window's metrics
    come to the host in one copy (a ``.item()`` a step would stall the
    card) and go to the meters and the log;
  * every ``val_step`` steps and at each epoch's end: validate - encode the
    minival split, matching-head R@K always, alignment-head i2t/t2i (the
    MrSw kernel on the card) when the loss set has 'alignment'; rsum =
    matching rsum (+ alignment rsum) gates the best checkpoint;
  * a checkpoint after each validation, copied on a new best.

The validation dataset is built with is_train=True, as the reference does.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from aladin_torch.config import DataArgs, ExperimentConfig
from aladin_torch.eval.encode import encode_data
from aladin_torch.eval.recall import compute_recall
from aladin_torch.eval.retrieval import evaluate_alignment_head
from aladin_torch.io.checkpoint import save_checkpoint
from aladin_torch.train.state import TrainState
from aladin_torch.train.step import make_eval_step, make_train_step
from aladin_torch.utils.logging import AverageMeter, LogCollector, setup_logger


class Trainer:
    def __init__(self, cfg: ExperimentConfig, args: DataArgs, model, state: TrainState,
                 train_loader, val_loader, device: torch.device,
                 compute_dtype: Optional[torch.dtype] = None):
        self.cfg = cfg
        self.args = args
        self.model = model
        self.state = state
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.device = torch.device(device)
        self.train_step = make_train_step(model, cfg, compute_dtype)
        self.eval_step = make_eval_step(model, compute_dtype)
        self.logger = setup_logger("vlpretrain", args.logger_name)
        self.best_rsum = -1.0
        self.last_metrics = {}

    def fit(self, start_epoch: int = 0) -> TrainState:
        for epoch in range(start_epoch, self.args.num_epochs):
            self.train_epoch(epoch)
            self._checkpoint(epoch, self.validate())
        return self.state

    def train_epoch(self, epoch: int) -> None:
        batch_time, data_time = AverageMeter(), AverageMeter()
        collector = LogCollector()
        step0 = self.state.step
        pending = []  # device metric dicts of the window since the last flush
        window_start = time.time()

        def flush(i):
            nonlocal window_start
            if not pending:
                return
            names = list(pending[0])
            host = torch.stack([torch.stack([m[k].float() for k in names])
                                for m in pending]).cpu()  # the window's one sync
            batch_time.update((time.time() - window_start) / len(pending), n=len(pending))
            for row in host.tolist():
                for k, v in zip(names, row):
                    collector.update(k, v, n=1)
            self.last_metrics = dict(zip(names, host[-1].tolist()))
            pending.clear()
            window_start = time.time()
            self.logger.info(f"Epoch: [{epoch}][{i}/{len(self.train_loader)}]\t{collector}\t"
                             f"lr {self.state.schedule(self.state.schedule_step - 1):.3g}\t"
                             f"Time {batch_time}\tData {data_time}")

        end = time.time()
        for i, batch in enumerate(self.train_loader.epoch(epoch)):
            data_time.update(time.time() - end, n=1)
            pending.append(self.train_step(self.state, batch, epoch))
            gstep = step0 + i + 1
            end = time.time()
            if gstep % self.args.log_step == 0:
                flush(i)
            if self.args.val_step > 0 and gstep % self.args.val_step == 0:
                flush(i)
                self._checkpoint(epoch, self.validate())
        flush(max(len(self.train_loader) - 1, 0))

    def validate(self) -> float:
        """Encode the validation split; returns rsum (matching, plus
        alignment when trained)."""
        if self.val_loader is None:
            return 0.0
        img_embs, cap_embs, img_lens, cap_lens = encode_data(self.eval_step, self.val_loader,
                                                             logger=self.logger)
        m = compute_recall(img_embs[:, 0, :], cap_embs[:, 0, :], device=self.device)
        self.logger.info("Matching: i2t %.1f/%.1f/%.1f t2i %.1f/%.1f/%.1f rsum %.1f"
                         % (m["i2t_r1"], m["i2t_r5"], m["i2t_r10"],
                            m["t2i_r1"], m["t2i_r5"], m["t2i_r10"], m["rsum"]))
        rsum = m["rsum"]
        if "alignment" in self.cfg.training.loss_types:
            scoring = torch.int8 if self.args.compute_dtype == "int8" else torch.bfloat16
            i2t, t2i, _ = evaluate_alignment_head(
                img_embs, cap_embs, img_lens, cap_lens,
                aggregation=self.cfg.training.alignment_mode, compute_dtype=scoring,
                device=self.device)
            rsum_align = i2t["r1"] + i2t["r5"] + i2t["r10"] + t2i["r1"] + t2i["r5"] + t2i["r10"]
            self.logger.info("Alignment: i2t %.1f/%.1f/%.1f t2i %.1f/%.1f/%.1f rsum %.1f"
                             % (i2t["r1"], i2t["r5"], i2t["r10"], t2i["r1"], t2i["r5"],
                                t2i["r10"], rsum_align))
            rsum += rsum_align
        return rsum

    def _checkpoint(self, epoch: int, rsum: float) -> str:
        is_best = rsum > self.best_rsum
        self.best_rsum = max(rsum, self.best_rsum)
        return save_checkpoint(self.args.logger_name, self.state, epoch + 1, self.cfg.to_dict(),
                               self.best_rsum, is_best_rsum=is_best, opt=vars(self.args))
