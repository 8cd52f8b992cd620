"""The training orchestrator: epochs, in-loop validation, checkpointing
(mirrors aladin_tpu/train/loop.py on one device).

  * per dispatch: one train step, or with ``--steps_per_dispatch K > 1`` a
    window of K steps (``make_multi_train_step``: one CUDA graph replay on
    the card); the epoch's remainder runs as single steps;
  * at every ``log_step`` boundary the pending metrics come to the host in
    one copy (a ``.item()`` a step would stall the card) and go to the
    meters and the log; ``log_step`` and ``val_step`` fire at the first
    window boundary at or past each multiple (``crossed``);
  * every ``val_step`` steps and at each epoch's end: validate - encode the
    minival split, matching-head R@K always, alignment-head i2t/t2i (the
    MrSw kernel on the card) when the loss set has 'alignment', with
    NDCG@25 when an NDCG scorer is given; rsum = matching rsum (+
    alignment rsum) gates the best checkpoint, and the alignment head's
    spice NDCG sum (i2t + t2i) gates the best-NDCG one;
  * a checkpoint after each validation, copied on a new best of either;
  * ``--profile_dir``: a ``torch.profiler`` trace of the dispatches that
    cover ``--profile_steps`` steps and of the loading of their batches,
    from the second dispatch of the first epoch this Trainer runs (the
    first, for an epoch of one dispatch), once, with the spans
    ``loop.data`` (the wait for the loader's next batch),
    ``loop.dispatch`` and ``loop.flush`` (the metrics' read-back and log);
    the counters it traced are logged beside its path;
  * TensorBoard scalars under ``logger_name`` (``utils/logging.py::
    make_tb_writer``, a no-op without tensorboard), with aladin_tpu's tags:
    at each flush, per step ``epoch``, ``step`` (the batch index), ``lr``
    (the rate that step's update used) and every metric the step returns,
    then ``batch_time`` and ``data_time``; at each validation
    ``matching/{r1,r5,r10,r1i,r5i,r10i,rsum}`` and, with the alignment
    head, ``alignment/{r1,r5,r10,r1i,r5i,r10i,medr,meanr,ndcg_rougel,
    ndcg_spice}`` and ``rsum`` (the alignment head's), at the step count;
  * with a ``mesh`` (as aladin_tpu's Trainer): the step over the mesh
    (data parallel over dp, the model sharded over tp), the logged metrics
    averaged over the ranks (``all_reduce_metrics``), validation encoded on
    every rank (with the sharded model under tp) and scored corpus-sharded
    over every rank (``sharded_matching_scores`` + ``compute_recall_from_
    scores``, the alignment head through ``sharded_mrsw_scores``); rank 0
    alone logs, writes the TensorBoard scalars, traces and writes the
    checkpoints (every rank gathers the tp shards first), and every rank
    waits at a barrier after each checkpoint.

The validation dataset is built with is_train=True, as the reference does.
"""

from __future__ import annotations

import itertools
import time
from typing import Optional, Tuple

import torch

from aladin_torch.config import DataArgs, ExperimentConfig
from aladin_torch.eval.encode import encode_data
from aladin_torch.eval.recall import compute_recall, compute_recall_from_scores
from aladin_torch.eval.retrieval import evaluate_alignment_head
from aladin_torch.io.checkpoint import save_checkpoint
from aladin_torch.parallel.distributed import (all_reduce_metrics, barrier, is_main_process,
                                               rank_logger)
from aladin_torch.parallel.mesh import Mesh, sharded_matching_scores, sharded_mrsw_scores
from aladin_torch.train.state import TrainState
from aladin_torch.train.step import make_eval_step, make_multi_train_step, make_train_step
from aladin_torch.utils import profiling
from aladin_torch.utils.logging import AverageMeter, LogCollector, NoOpWriter, make_tb_writer


def crossed(gstep: int, width: int, period: int) -> bool:
    """Did a positive multiple of ``period`` land in (gstep - width, gstep]?"""
    r = gstep % period
    return r < width and r < gstep


class Trainer:
    def __init__(self, cfg: ExperimentConfig, args: DataArgs, model, state: TrainState,
                 train_loader, val_loader, device: torch.device,
                 compute_dtype: Optional[torch.dtype] = None, ndcg_scorer=None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.args = args
        self.model = model
        self.state = state
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.device = torch.device(device)
        self.steps_per_dispatch = int(getattr(args, "steps_per_dispatch", 1))
        if self.steps_per_dispatch < 1:
            raise ValueError(f"--steps_per_dispatch must be >= 1, got {self.steps_per_dispatch}")
        self.mesh = mesh
        self.train_step = make_train_step(model, cfg, compute_dtype, mesh)
        self.multi_step = (make_multi_train_step(model, cfg, compute_dtype,
                                                 self.steps_per_dispatch, mesh)
                           if self.steps_per_dispatch > 1 else None)
        self.profile_dir = getattr(args, "profile_dir", "") if is_main_process() else ""
        self.profile_steps = int(getattr(args, "profile_steps", 5))
        if self.profile_dir and self.profile_steps < 1:
            raise ValueError(f"--profile_steps must be >= 1, got {self.profile_steps}")
        self.profiled = False  # one trace a Trainer
        self.eval_step = make_eval_step(model, compute_dtype)
        self.logger = rank_logger(args.logger_name)
        self.tb = make_tb_writer(args.logger_name) if is_main_process() else NoOpWriter()
        self.ndcg_scorer = ndcg_scorer
        self.best_rsum = -1.0
        self.best_ndcgspice = -1.0
        self.last_metrics = {}

    def fit(self, start_epoch: int = 0) -> TrainState:
        for epoch in range(start_epoch, self.args.num_epochs):
            self.train_epoch(epoch)
            self._checkpoint(epoch, *self.validate())
        self.tb.flush()
        return self.state

    def train_epoch(self, epoch: int) -> None:
        batch_time, data_time = AverageMeter(), AverageMeter()
        collector = LogCollector()
        k = self.steps_per_dispatch
        step0 = self.state.step
        pending = []  # device metric dicts, (width,) tensors or scalars, since the last flush
        pending_steps = []  # (global step, batch index) of each pending step
        window_start = time.time()

        def flush(i):
            nonlocal window_start
            if not pending:
                return
            with profiling.span("loop.flush"):
                names = list(pending[0])
                host = torch.cat([torch.stack([m[n].float().reshape(-1) for n in names])
                                  for m in pending], dim=1).cpu()  # the window's one sync
                batch_time.update((time.time() - window_start) / host.shape[1], n=host.shape[1])
                for col, (gstep, bi) in zip(host.T.tolist(), pending_steps):
                    for n, v in zip(names, col):
                        collector.update(n, v, n=1)
                    self.tb.add_scalar("epoch", epoch, gstep)
                    self.tb.add_scalar("step", bi, gstep)
                    self.tb.add_scalar("lr", self.state.schedule(
                        gstep - 1 - self.state.schedule_offset), gstep)
                    collector.tb_log(self.tb, step=gstep)
                last_step = pending_steps[-1][0]
                self.tb.add_scalar("batch_time", batch_time.val, last_step)
                self.tb.add_scalar("data_time", data_time.val, last_step)
                pending_steps.clear()
                last = dict(zip(names, host[:, -1].tolist()))
                self.last_metrics = last if self.mesh is None else all_reduce_metrics(last)
                pending.clear()
                window_start = time.time()
                self.logger.info(f"Epoch: [{epoch}][{i}/{len(self.train_loader)}]\t{collector}\t"
                                 f"lr {self.state.schedule(self.state.schedule_step - 1):.3g}\t"
                                 f"Time {batch_time}\tData {data_time}")

        ndisp = 0  # dispatches issued this epoch
        prof = None
        prof_start = 1 if len(self.train_loader) > k else 0

        def prof_tick():
            nonlocal prof
            if not self.profile_dir or self.profiled:
                return
            if prof is None and ndisp == prof_start:
                prof = profiling.Trace(self.profile_dir, cuda=self.device.type == "cuda")
                prof.start()
            elif prof is not None and (ndisp - prof_start) * k >= self.profile_steps:
                self._stop_trace(prof)
                prof = None

        window, widx = [], []

        def dispatch():
            nonlocal ndisp
            with profiling.span("loop.dispatch"):
                if self.multi_step is None:
                    pending.append(self.train_step(self.state, window[0], epoch))
                else:
                    pending.append(self.multi_step(self.state, list(window), epoch))
            ndisp += 1
            pending_steps.extend((step0 + bi + 1, bi) for bi in widx)
            gstep, i, width = step0 + widx[-1] + 1, widx[-1], len(widx)
            window.clear()
            widx.clear()
            if crossed(gstep, width, self.args.log_step):
                flush(i)
            if self.args.val_step > 0 and crossed(gstep, width, self.args.val_step):
                flush(i)
                self._checkpoint(epoch, *self.validate())

        end = time.time()
        batches = iter(self.train_loader.epoch(epoch))
        for i in itertools.count():
            if not window:  # a trace covers its windows' batches from their first
                prof_tick()
            with profiling.span("loop.data"):
                batch = next(batches, None)
            if batch is None:
                break
            data_time.update(time.time() - end, n=1)
            window.append(batch)
            widx.append(i)
            if len(window) == k:
                dispatch()
            end = time.time()
        if window:
            dispatch()  # the epoch's remainder
        if prof is not None:  # an epoch shorter than the trace
            self._stop_trace(prof)
        flush(max(len(self.train_loader) - 1, 0))

    def _stop_trace(self, prof: profiling.Trace) -> None:
        path, traced = prof.stop()
        self.profiled = True
        self.logger.info(f"profiler trace ({self.profile_steps} steps) -> {path}; "
                         f"traced counters {dict(sorted(traced.items()))}")

    def validate(self) -> Tuple[float, float]:
        """Encode the validation split; returns (rsum: matching, plus
        alignment when trained; the alignment head's spice NDCG sum, 0
        without a scorer or an alignment loss)."""
        if self.val_loader is None:
            return 0.0, 0.0
        step = self.state.step
        img_embs, cap_embs, img_lens, cap_lens = encode_data(self.eval_step, self.val_loader,
                                                             logger=self.logger)
        score_fn = None
        if self.mesh is None:
            m = compute_recall(img_embs[:, 0, :], cap_embs[:, 0, :], device=self.device)
        else:
            m = compute_recall_from_scores(sharded_matching_scores(
                self.mesh, img_embs[::5, 0, :], cap_embs[:, 0, :]))
        for tag, key in (("r1", "i2t_r1"), ("r5", "i2t_r5"), ("r10", "i2t_r10"),
                         ("r1i", "t2i_r1"), ("r5i", "t2i_r5"), ("r10i", "t2i_r10"),
                         ("rsum", "rsum")):
            self.tb.add_scalar(f"matching/{tag}", m[key], step)
        self.logger.info("Matching: i2t %.1f/%.1f/%.1f t2i %.1f/%.1f/%.1f rsum %.1f"
                         % (m["i2t_r1"], m["i2t_r5"], m["i2t_r10"],
                            m["t2i_r1"], m["t2i_r5"], m["t2i_r10"], m["rsum"]))
        rsum, ndcg_sum = m["rsum"], 0.0
        if "alignment" in self.cfg.training.loss_types:
            scoring = torch.int8 if self.args.compute_dtype == "int8" else torch.bfloat16
            if self.mesh is not None:
                def score_fn(ims, caps, il, cl):
                    return sharded_mrsw_scores(self.mesh, ims, caps, il, cl,
                                               aggregation=self.cfg.training.alignment_mode,
                                               compute_dtype=scoring)
            i2t, t2i, _ = evaluate_alignment_head(
                img_embs, cap_embs, img_lens, cap_lens,
                aggregation=self.cfg.training.alignment_mode, compute_dtype=scoring,
                device=self.device, ndcg_scorer=self.ndcg_scorer, score_fn=score_fn)
            rsum_align = i2t["r1"] + i2t["r5"] + i2t["r10"] + t2i["r1"] + t2i["r5"] + t2i["r10"]
            ndcg_sum = i2t["ndcg_spice"] + t2i["ndcg_spice"]
            for tag, v in (("r1", i2t["r1"]), ("r5", i2t["r5"]), ("r10", i2t["r10"]),
                           ("r1i", t2i["r1"]), ("r5i", t2i["r5"]), ("r10i", t2i["r10"]),
                           ("medr", i2t["medr"]), ("meanr", i2t["meanr"]),
                           ("ndcg_rougel", i2t["ndcg_rougel"] + t2i["ndcg_rougel"]),
                           ("ndcg_spice", ndcg_sum)):
                self.tb.add_scalar(f"alignment/{tag}", v, step)
            self.tb.add_scalar("rsum", rsum_align, step)
            self.logger.info("Alignment: i2t %.1f/%.1f/%.1f t2i %.1f/%.1f/%.1f rsum %.1f "
                             "ndcg_rouge %.4f ndcg_spice %.4f"
                             % (i2t["r1"], i2t["r5"], i2t["r10"], t2i["r1"], t2i["r5"],
                                t2i["r10"], rsum_align, i2t["ndcg_rougel"] + t2i["ndcg_rougel"],
                                ndcg_sum))
            rsum += rsum_align
        return rsum, ndcg_sum

    def _checkpoint(self, epoch: int, rsum: float, ndcg_sum: float = 0.0) -> str:
        is_best = rsum > self.best_rsum
        self.best_rsum = max(rsum, self.best_rsum)
        is_best_ndcg = self.ndcg_scorer is not None and ndcg_sum > self.best_ndcgspice
        self.best_ndcgspice = max(ndcg_sum, self.best_ndcgspice)
        path = save_checkpoint(self.args.logger_name, self.state, epoch + 1, self.cfg.to_dict(),
                               self.best_rsum, is_best_rsum=is_best, opt=vars(self.args),
                               is_best_ndcgspice=is_best_ndcg, mesh=self.mesh)
        if self.mesh is not None:
            barrier("checkpoint")
        return path
