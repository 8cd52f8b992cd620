"""The port's training slice against aladin_tpu on the CPU: the LR schedule,
one train step (every loss term, grad_norm, the gradients by name, the
params after clip + Adam), learning over steps, and cli/train end to end.

Both packages start from the same seeded Flax parameters (carried across by
``params_from_flax``) and the same numpy batch, in f32 with dropout 0.
Tolerances:
  * loss terms and grad_norm: rtol 1e-4, the same f32 math summed in
    another order (observed ~1e-6 relative);
  * gradients: atol 1e-5 of the largest gradient entry plus rtol 1e-4,
    for the same reason (observed up to 6.3e-7 of the largest entry);
  * params after one clip + Adam step: atol 1e-6 where |g| exceeds 1e-4 of
    the largest gradient entry, 100 times the gradients' disagreement.
    Nearer 0 a gradient can be rounding noise (the key biases' true
    gradient is zero: softmax ignores a per-row shift), and Adam's first
    step -lr * g / (|g| + eps) turns noise of either sign into an update of
    up to lr; there the update must only stay within lr.
"""

import copy
import dataclasses
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from aladin_tpu.config import ExperimentConfig as JaxExperimentConfig
from aladin_tpu.config import TrainingConfig as JaxTrainingConfig
from aladin_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from aladin_tpu.io.checkpoint import load_teacher_params as jax_load_teacher_params
from aladin_tpu.io.checkpoint import resume_state as jax_resume_state
from aladin_tpu.models.aladin import ALADIN as JaxALADIN
from aladin_tpu.train.schedule import make_lr_schedule as jax_schedule
from aladin_tpu.train.state import create_train_state
from aladin_tpu.train.step import make_loss_fn as jax_make_loss_fn
from aladin_tpu.train.step import make_multi_train_step as jax_make_multi_train_step
from aladin_tpu.train.step import make_train_step as jax_make_train_step
from aladin_torch.cli import train as torch_train_cli
from aladin_torch.config import ExperimentConfig, TrainingConfig
from aladin_torch.io.checkpoint import (
    load_checkpoint,
    load_teacher_params,
    resume_state,
    save_checkpoint,
)
from aladin_torch.io.convert import aux_from_flax, params_from_flax, state_dict_from_flax
from aladin_torch.models.aladin import ALADIN, Batch
from aladin_torch.models.bert_img import BertImgConfig
from aladin_torch.train.schedule import make_lr_schedule
from aladin_torch.train.loop import crossed
from aladin_torch.train.state import TrainState
from aladin_torch.train.step import make_loss_fn, make_multi_train_step, make_train_step
from tests.test_models import SMALL, make_batch, small_cfg

LR = 1e-3
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)

CASES = {
    "flagship": {"loss-type": "alignment-distillation", "loss-weights": [1, 1]},
    "auto": {"loss-type": "alignment-distillation-matching", "loss-weights": "auto"},
    "gate_closed": {"loss-type": "alignment-distillation", "loss-weights": "auto",
                    "activate-distillation-after": 2},
    "mse_entropy": {"loss-type": "matching-distillation-entropy", "loss-weights": [1, 0.5, 0.1],
                    "distillation-mode": "mse"},
    "freeze_teran": {"loss-type": "alignment-distillation", "loss-weights": [1, 1],
                     "model": {"freeze-teran": True}},
}


def _recipe(case, training_over=None):
    training = {k: v for k, v in CASES[case].items() if k != "model"}
    return {"model": {"embed-size": SMALL["hidden_size"], "tern-layers": 1, "dropout": 0.0,
                      **CASES[case].get("model", {})},
            "training": {**training, "lr": LR, "bs": 4, "grad-clip": 2.0,
                         **(training_over or {})}}


def _torch_batch(jb) -> Batch:
    return Batch(**{f: torch.from_numpy(np.array(getattr(jb, f)))
                    for f in Batch.__dataclass_fields__})


def _both(case, rng, training_over=None):
    """(jax model, jax state, port model, port state, jax batch, port batch)."""
    d = _recipe(case, training_over)
    jmodel = JaxALADIN(JaxExperimentConfig.from_dict(d),
                       dataclasses.replace(small_cfg(), **NO_DROPOUT))
    jbatch = make_batch(rng)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, True)["params"]
    jstate = create_train_state(JaxExperimentConfig.from_dict(d), params, steps_per_epoch=10)
    model = ALADIN(ExperimentConfig.from_dict(d), BertImgConfig(**SMALL, **NO_DROPOUT))
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    state = TrainState(ExperimentConfig.from_dict(d), model, steps_per_epoch=10)
    with torch.no_grad():
        for k, v in aux_from_flax(jax.tree.map(np.asarray, jstate.params["aux"])).items():
            state.aux[k].copy_(v)
    return jmodel, jstate, model, state, jbatch, _torch_batch(jbatch)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_terms_and_gradients_match(rng, case):
    jmodel, jstate, model, state, jbatch, batch = _both(case, rng)
    epoch = 0
    jcfg = JaxExperimentConfig.from_dict(_recipe(case))
    (_, jm), jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel, jcfg), has_aux=True))(
        jstate.params, jbatch, jnp.int32(epoch), jax.random.PRNGKey(1))
    model.train()
    total, metrics = make_loss_fn(model, state.cfg)(state.aux, batch, epoch)
    total.backward()
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-4, err_msg=k)

    want = params_from_flax(jax.tree.map(np.asarray, jgrads))
    got = state.named_params()
    assert set(want) == set(got)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, w in want.items():
        g = got[name].grad
        g = torch.zeros_like(got[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    if case == "gate_closed":  # the whole distillation term is gated, its +s included
        assert want["aux.loss_weights.distillation"].abs().max().item() == 0.0
        assert got["aux.loss_weights.distillation"].grad.abs().max().item() == 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_step_matches(rng, case):
    """grad_norm (over every gradient) and the params after clip + Adam."""
    jmodel, jstate, model, state, jbatch, batch = _both(case, rng)
    jcfg = JaxExperimentConfig.from_dict(_recipe(case))
    _, jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel, jcfg), has_aux=True))(
        jstate.params, jbatch, jnp.int32(0), jax.random.PRNGKey(1))
    grads = params_from_flax(jax.tree.map(np.asarray, jgrads))
    before = params_from_flax(jax.tree.map(np.asarray, jstate.params))  # the step donates them
    new_jstate, jm = jax_make_train_step(jmodel, jcfg)(jstate, jbatch, jnp.int32(0),
                                                       jax.random.PRNGKey(1))
    metrics = make_train_step(model, state.cfg)(state, batch, 0)
    assert state.step == int(new_jstate.step) == 1
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-4)

    want = params_from_flax(jax.tree.map(np.asarray, new_jstate.params))
    scale = max(float(np.abs(g.numpy()).max()) for g in grads.values())
    for name, p in state.named_params().items():
        got, w = p.detach().numpy(), want[name].numpy()
        live = np.abs(grads[name].numpy()) > 1e-4 * scale
        np.testing.assert_allclose(got[live], w[live], atol=1e-6, err_msg=name)
        assert np.all(np.abs(got - before[name].numpy()) <= LR * 1.001), name
    if case == "freeze_teran":
        for name, p in model.oscar_model.named_parameters():
            assert torch.equal(p.detach(), before["oscar_model." + name]), name


def test_loss_falls_over_steps(rng):
    """The recipe learns: 8 steps on one batch lower the loss (with dropout
    at its default 0.1)."""
    d = _recipe("flagship")
    d["model"]["dropout"] = 0.1
    model = ALADIN(ExperimentConfig.from_dict(d), BertImgConfig(**SMALL))
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = TrainState(ExperimentConfig.from_dict(d), model, steps_per_epoch=10)
    step = make_train_step(model, state.cfg)
    batch = _torch_batch(make_batch(rng))
    losses = [step(state, batch, 0)["loss"].item() for _ in range(8)]
    assert losses[-1] < losses[0], losses
    assert state.step == 8


@pytest.mark.parametrize("over", [
    {"scheduler": "steplr", "step-size": 2, "gamma": 0.1},
    {"scheduler": None, "warmup": "linear", "warmup-period": 7},
    {"scheduler": "steplr", "step-size": 1, "gamma": 0.5, "warmup": "linear",
     "warmup-period": 5},
])
def test_lr_schedule_matches(over):
    d = {"lr": 2e-4, **over}
    ours = make_lr_schedule(TrainingConfig.from_dict(d), steps_per_epoch=3)
    ref = jax_schedule(JaxTrainingConfig.from_dict(d), steps_per_epoch=3)
    for step in range(20):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, err_msg=str(step))


CLI = ["--config", os.path.join(os.path.dirname(os.path.dirname(__file__)), "aladin_torch",
                                "configs", "alad-alignment-and-matching-distill.json"),
       "--synthetic", "--device", "cpu", "--max_seq_length", "20", "--max_img_seq_length", "12",
       "--img_feature_dim", "32", "--num_workers", "1", "--log_step", "1", "--val_step", "0"]


def test_train_cli_runs_saves_and_resumes(tmp_path):
    """One epoch writes a checkpoint the port and aladin_tpu both read with
    equal weights; --resume continues the step count and the epoch."""
    run = str(tmp_path / "run")
    out = torch_train_cli.run(CLI + ["--output_dir", str(tmp_path), "--logger_name", run,
                                     "--num_epochs", "1"])
    steps = out["state"].step
    assert steps == len(out["trainer"].train_loader) >= 1
    assert all(np.isfinite(v) for v in out["trainer"].last_metrics.values())
    path = out["checkpoint"]
    assert os.path.exists(os.path.join(run, "model_best_rsum.pth.tar"))

    payload, config = load_checkpoint(path)
    assert payload["step"] == steps and payload["epoch"] == 1
    assert config["training"]["loss-type"] == "alignment-distillation"
    jpayload, _ = jax_load_checkpoint(path)
    want = state_dict_from_flax(jpayload["params"]["model"])
    sd = out["state"].model.state_dict()
    assert set(want) == set(sd)
    for k, v in want.items():
        assert torch.equal(v, sd[k].cpu()), k

    again = torch_train_cli.run(CLI + ["--output_dir", str(tmp_path), "--logger_name", run,
                                       "--num_epochs", "2", "--resume", path])
    assert again["state"].step == 2 * steps
    assert load_checkpoint(again["checkpoint"])[0]["epoch"] == 2


@pytest.mark.parametrize("flags", [["--mesh_shape", "dp=1,tp=2"]])
def test_train_cli_unported_flags_raise(flags, tmp_path):
    """A tp axis: tensor parallelism is not ported (ROADMAP.md item 7b)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_train_cli.main(CLI + ["--output_dir", str(tmp_path), *flags])


def test_train_cli_refuses_int8_encoder(tmp_path):
    with pytest.raises(SystemExit):
        torch_train_cli.main(CLI + ["--output_dir", str(tmp_path), "--int8_encoder"])


def _small_state(d, seed):
    model = ALADIN(ExperimentConfig.from_dict(d), BertImgConfig(**SMALL, **NO_DROPOUT))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return TrainState(ExperimentConfig.from_dict(d), model, steps_per_epoch=10)


def test_load_teacher_params_matches_jax(rng, tmp_path):
    """A file the port saved from a 2-layer matching head, merged
    non-strictly into a 1-layer student by both packages: the same params
    after, and the teacher's second layer reported unused."""
    d = _recipe("flagship")
    teacher = _small_state({**d, "model": {**d["model"], "tern-layers": 2}}, seed=3)
    path = save_checkpoint(str(tmp_path), teacher, 1, teacher.cfg.to_dict(), 0.0)

    jmodel, jstate, _, state, _, _ = _both("flagship", rng)
    want = params_from_flax(jax.tree.map(np.asarray, jax_load_teacher_params(jstate, path).params))
    stats = load_teacher_params(state, path)
    assert stats["unused"] and all(k.startswith("final_projection_net.layers.1.")
                                   for k in stats["unused"])
    assert stats["missing"] == [] and stats["matched"] == len(state.model.state_dict())
    for name, p in state.named_params().items():
        assert torch.equal(p.detach(), want[name]), name


def test_resume_from_a_weights_only_file_restarts_the_optimizer(rng, tmp_path):
    """A .pth.tar without the port's optimizer state (the reference's
    released layout) restores weights, epoch and step; Adam starts fresh."""
    src = _small_state(_recipe("auto"), seed=4)
    src.step = 7
    path = save_checkpoint(str(tmp_path), src, 3, src.cfg.to_dict(), 12.5)
    ckpt = torch.load(path, weights_only=False)
    ref = str(tmp_path / "reference.pth.tar")
    torch.save({k: ckpt[k] for k in ("epoch", "model", "opt", "config", "Eiters")}, ref)

    state = _small_state(_recipe("auto"), seed=5)
    state, epoch, best = resume_state(state, ref)
    assert (state.step, epoch, best) == (7, 3, 0.0)
    assert state.optimizer.state_dict()["state"] == {}
    for (name, p), q in zip(state.model.named_parameters(), src.model.parameters()):
        assert torch.equal(p, q), name


# steplr at every epoch of 10 steps: a schedule read at Eiters 25 instead
# of 0 gives lr / 100
DECAYING = {"step-size": 1, "gamma": 0.1}
EITERS = 25


def _weights_only_file(tmp_path, case="flagship", seed=4):
    """A .pth.tar in the released reference's layout (no optimizer state,
    no aux) at epoch 2, Eiters 25."""
    src = _small_state(_recipe(case), seed=seed)
    src.step = EITERS
    path = save_checkpoint(str(tmp_path), src, 2, src.cfg.to_dict(), 0.0)
    ckpt = torch.load(path, weights_only=False)
    ref = str(tmp_path / "reference.pth.tar")
    torch.save({k: ckpt[k] for k in ("epoch", "model", "opt", "config", "Eiters")}, ref)
    return ref


def _schedule_count(opt_state) -> int:
    """optax's count of the learning-rate schedule in an opt_state."""
    def is_sched(s):
        return isinstance(s, optax.ScaleByScheduleState)

    counts = {int(s.count) for s in jax.tree.leaves(opt_state, is_leaf=is_sched) if is_sched(s)}
    assert len(counts) == 1, counts
    return counts.pop()


def test_weights_only_resume_restarts_the_schedule_like_jax(rng, tmp_path):
    """Both packages resume from one weights-only file (Eiters 25) and take
    two steps on one batch: each step's lr is the schedule's at 0 and 1 in
    both (aladin_tpu's fresh optax state restarts its count), the step count
    continues from Eiters, and the params agree within the post-Adam
    tolerance of ``test_one_step_matches`` (atol 1e-6 where both steps'
    gradients exceed 1e-4 of the largest; elsewhere each update stays
    within lr)."""
    jmodel, jstate, model, state, jbatch, batch = _both("flagship", rng, DECAYING)
    jcfg = JaxExperimentConfig.from_dict(_recipe("flagship", DECAYING))
    ref = _weights_only_file(tmp_path)
    jstate, jepoch, _ = jax_resume_state(jstate, ref)
    state, epoch, _ = resume_state(state, ref)
    assert epoch == jepoch == 2 and state.step == int(jstate.step) == EITERS
    assert state.schedule_offset == EITERS

    sched = jax_schedule(jcfg.training, steps_per_epoch=10)
    assert float(sched(EITERS)) < 0.02 * float(sched(0))  # a restart is visible in the lr
    before = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    grad_fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel, jcfg), has_aux=True))
    jstep, step = jax_make_train_step(jmodel, jcfg), make_train_step(model, state.cfg)
    live = None
    for i in range(2):
        _, jgrads = grad_fn(jstate.params, jbatch, jnp.int32(0), jax.random.PRNGKey(1))
        grads = params_from_flax(jax.tree.map(np.asarray, jgrads))
        scale = max(float(np.abs(g.numpy()).max()) for g in grads.values())
        big = {k: np.abs(g.numpy()) > 1e-4 * scale for k, g in grads.items()}
        live = big if live is None else {k: live[k] & big[k] for k in big}
        assert _schedule_count(jstate.opt_state) == state.schedule_step == i
        jstate, _ = jstep(jstate, jbatch, jnp.int32(0), jax.random.PRNGKey(1))
        step(state, batch, 0)
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(float(sched(i)), rel=1e-6)
    assert state.step == int(jstate.step) == EITERS + 2

    want = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name, p in state.named_params().items():
        got, w = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got[live[name]], w[live[name]], atol=1e-6, err_msg=name)
        assert np.all(np.abs(got - before[name].numpy()) <= 2 * LR * 1.001), name


def test_full_resume_continues_the_schedule_of_a_weights_only_resume(tmp_path):
    """A file the port saves after a weights-only resume keeps the offset:
    a full resume from it reads the schedule at step - offset, and so does
    the Trainer's lr log."""
    d = _recipe("flagship", DECAYING)
    state, _, _ = resume_state(_small_state(d, seed=5), _weights_only_file(tmp_path))
    batch = _torch_batch(make_batch(np.random.RandomState(0)))
    make_train_step(state.model, state.cfg)(state, batch, 0)
    path = save_checkpoint(str(tmp_path / "later"), state, 3, state.cfg.to_dict(), 1.0)
    assert torch.load(path, weights_only=False)["schedule_offset"] == EITERS

    again, epoch, _ = resume_state(_small_state(d, seed=6), path)
    assert (again.step, again.schedule_offset, again.schedule_step, epoch) == (
        EITERS + 1, EITERS, 1, 3)
    make_train_step(again.model, again.cfg)(again, batch, 0)
    assert again.optimizer.param_groups[0]["lr"] == again.schedule(1) == LR


def test_full_resume_from_a_file_without_the_offset_reads_zero(tmp_path):
    """Files written before the offset was saved load as full resumes with
    offset 0: the schedule runs at the step count, as it did."""
    d = _recipe("flagship", DECAYING)
    src = _small_state(d, seed=7)
    src.step = EITERS
    path = save_checkpoint(str(tmp_path), src, 2, src.cfg.to_dict(), 0.5)
    ckpt = torch.load(path, weights_only=False)
    del ckpt["schedule_offset"]
    torch.save(ckpt, path)

    state, _, best = resume_state(_small_state(d, seed=8), path)
    assert (state.step, state.schedule_offset, best) == (EITERS, 0, 0.5)
    make_train_step(state.model, state.cfg)(state, _torch_batch(make_batch(
        np.random.RandomState(0))), 0)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(state.schedule(EITERS))
    assert state.schedule(EITERS) == pytest.approx(LR * 0.01)


def test_orbax_directories_are_refused(tmp_path):
    state = _small_state(_recipe("flagship"), seed=6)
    for fn in (load_checkpoint, lambda p: resume_state(state, p),
               lambda p: load_teacher_params(state, p)):
        with pytest.raises(NotImplementedError, match="orbax"):
            fn(str(tmp_path))


# --steps_per_dispatch: a window of K steps is one dispatch (one CUDA graph
# replay on the card, tests/test_torch_gpu.py); on the CPU it is K eager
# steps, and everywhere it must equal K single steps.

def _dropout_state(seed=0):
    """A small flagship state with dropout 0.1 and both kernel knobs (their
    plain versions on the CPU), weights from ``seed``."""
    d = _recipe("flagship")
    d["model"]["dropout"] = 0.1
    model = ALADIN(ExperimentConfig.from_dict(d),
                   BertImgConfig(**SMALL, fused_attention=True, fused_layernorm=True))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return TrainState(ExperimentConfig.from_dict(d), model, steps_per_epoch=2)


def _reseed(state, seed):
    torch.manual_seed(seed)
    state.model.oscar_model.bert.seed_generator.manual_seed(seed)


@pytest.mark.parametrize("k", [2, 3])
def test_window_equals_single_steps_with_dropout(rng, k):
    """K steps as one window give the params, Adam state and per-step
    metrics of K single steps exactly, dropout on (both draw the same
    numbers from the same generators), across a schedule decay."""
    batches = [_torch_batch(make_batch(np.random.RandomState(s))) for s in range(k)]
    a, b = _dropout_state(), _dropout_state()
    _reseed(a, 7)
    step = make_train_step(a.model, a.cfg)
    singles = [step(a, x, 0) for x in batches]
    _reseed(b, 7)
    window = make_multi_train_step(b.model, b.cfg, k=k)(b, batches, 0)
    assert a.step == b.step == k
    assert set(window) == set(singles[0])
    for name, v in window.items():
        assert v.shape == (k,)
        assert torch.equal(v, torch.stack([m[name] for m in singles])), name
    for (name, p), q in zip(a.named_params().items(), b.named_params().values()):
        assert torch.equal(p, q), name
    for p, q in zip(a.trainable, b.trainable):
        for key, v in a.optimizer.state[p].items():
            assert torch.equal(v, b.optimizer.state[q][key]), key


def test_window_matches_jax_multi_step(rng):
    """The port's K=4 window against aladin_tpu's make_multi_train_step at
    dropout 0 from the same weights and batches: each step's loss terms and
    grad_norm, and the params after 4 clip + Adam steps, to the one-step
    test's tolerances (rtol 1e-4; atol 1e-6 on entries whose first gradient
    exceeds 1e-4 of the largest, and every entry within 4 lr of JAX's)."""
    k = 4
    jmodel, jstate, model, state, jbatch, _ = _both("auto", rng)
    jcfg = JaxExperimentConfig.from_dict(_recipe("auto"))
    jbatches = [make_batch(np.random.RandomState(10 + s)) for s in range(k)]
    _, jgrads = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel, jcfg), has_aux=True))(
        jstate.params, jbatches[0], jnp.int32(0), jax.random.PRNGKey(1))
    grads = params_from_flax(jax.tree.map(np.asarray, jgrads))
    new_jstate, jm = jax_make_multi_train_step(jmodel, jcfg)(jstate, jbatches, jnp.int32(0),
                                                             jax.random.PRNGKey(1))
    metrics = make_multi_train_step(model, state.cfg, k=k)(
        state, [_torch_batch(b) for b in jbatches], 0)
    assert state.step == int(new_jstate.step) == k
    assert set(metrics) == set(jm)
    for name, v in jm.items():
        np.testing.assert_allclose(metrics[name].numpy(), np.asarray(v), rtol=1e-4, err_msg=name)
    want = params_from_flax(jax.tree.map(np.asarray, new_jstate.params))
    scale = max(float(np.abs(g.numpy()).max()) for g in grads.values())
    for name, p in state.named_params().items():
        got, w = p.detach().numpy(), want[name].numpy()
        live = np.abs(grads[name].numpy()) > 1e-4 * scale
        np.testing.assert_allclose(got[live], w[live], atol=1e-6, err_msg=name)
        assert np.all(np.abs(got - w) <= k * LR * 1.001), name


def test_train_cli_steps_per_dispatch_matches(tmp_path):
    """--steps_per_dispatch 3 through the CLI: 5 batches an epoch make a
    window of 3 and a remainder of 2 each epoch. Final weights, Adam state,
    step, epoch and best_rsum equal the K=1 run's exactly."""
    import json

    with open(CLI[1]) as f:
        recipe = json.load(f)
    recipe["training"]["bs"] = 8  # the synthetic corpus: 40 captions -> 5 batches
    cfg_path = str(tmp_path / "k_recipe.json")
    with open(cfg_path, "w") as f:
        json.dump(recipe, f)
    runs = {}
    for k in ("1", "3"):
        out = str(tmp_path / f"spd_{k}")
        argv = CLI[2:] + ["--config", cfg_path, "--output_dir", out, "--logger_name", out,
                          "--num_epochs", "2", "--log_step", "4", "--steps_per_dispatch", k]
        res = torch_train_cli.run(argv)
        assert len(res["trainer"].train_loader) == 5
        runs[k] = torch.load(res["checkpoint"], weights_only=False)
    a, b = runs["1"], runs["3"]
    assert (a["best_rsum"], a["epoch"], a["Eiters"]) == (b["best_rsum"], b["epoch"], b["Eiters"])
    assert a["Eiters"] == 10
    assert set(a["model"]) == set(b["model"])
    for name, v in a["model"].items():
        assert torch.equal(v, b["model"][name]), name
    for i, st in a["optimizer"]["state"].items():
        for key, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][key]), (i, key)


def test_crossed_fires_at_the_first_window_boundary_past_each_multiple():
    """log_step / val_step in windows: a period fires once per multiple, at
    the window that contains it, and never at step 0; with width 1 it is
    gstep % period == 0."""
    for period in (1, 2, 3, 4, 7):
        for width in (1, 2, 3, 5):
            fired = [g for g in range(width, 60, width) if crossed(g, width, period)]
            want = [g for g in range(width, 60, width)
                    if any(m % period == 0 for m in range(g - width + 1, g + 1))]
            assert fired == want, (period, width)
            if width == 1:
                assert fired == [g for g in range(1, 60) if g % period == 0]
    assert not crossed(0, 1, 5)


def test_capturable_optimizer_state_loads_into_an_eager_state_and_back(rng):
    """The card's capturable Adam (a tensor lr, step counts beside the
    params) and the CPU's eager Adam load each other's state dicts, and the
    checkpoint form is the eager one in both modes."""
    batches = [_torch_batch(make_batch(np.random.RandomState(s))) for s in range(3)]
    d = _recipe("auto")
    eager = _small_state(d, seed=3)
    step = make_train_step(eager.model, eager.cfg)
    for x in batches[:2]:
        step(eager, x, 0)
    saved = copy.deepcopy(eager.optimizer_state_dict())  # state dicts hold the live moments
    own = eager.optimizer.state_dict()  # the eager form is the optimizer's own
    assert saved["param_groups"] == own["param_groups"]
    assert all(torch.equal(v, own["state"][i][key])
               for i, st in saved["state"].items() for key, v in st.items())

    cap = TrainState(ExperimentConfig.from_dict(d), eager.model, steps_per_epoch=10)
    # the optimizer a card state builds, here over CPU parameters: it loads
    # and gives state dicts there, though it cannot step
    cap.capturable = True
    cap.optimizer = torch.optim.Adam(cap.trainable, lr=torch.tensor(cap.schedule(0)),
                                     betas=(0.9, 0.999), eps=1e-8, capturable=True)
    cap.load_optimizer_state_dict(copy.deepcopy(saved))
    group = cap.optimizer.param_groups[0]
    assert group["capturable"] and torch.is_tensor(group["lr"])
    assert float(group["lr"]) == pytest.approx(saved["param_groups"][0]["lr"])
    assert len(cap.optimizer.state) == len(eager.optimizer.state) > 0
    for p, st in cap.optimizer.state.items():
        assert st["step"].device == p.device and st["step"].dtype == torch.float32

    for raw in map(copy.deepcopy, (cap.optimizer.state_dict(), cap.optimizer_state_dict())):
        back = _small_state(d, seed=3)
        with torch.no_grad():
            for p, q in zip(back.trainable, eager.trainable):
                p.copy_(q)
        back.step = eager.step
        back.load_optimizer_state_dict(raw)
        group = back.optimizer.param_groups[0]
        assert not group["capturable"] and isinstance(group["lr"], float)
        # the capturable state holds lr in f32 (the step rewrites it from the schedule)
        (g_back,), (g_saved,) = back.optimizer_state_dict()["param_groups"], saved["param_groups"]
        assert g_back.pop("lr") == pytest.approx(g_saved["lr"], rel=1e-7)
        assert g_back == {k: v for k, v in g_saved.items() if k != "lr"}
        # the next step from the loaded state equals the original's
        twin = _small_state(d, seed=3)
        with torch.no_grad():
            for p, q in zip(twin.trainable, eager.trainable):
                p.copy_(q)
        twin.step = eager.step
        twin.load_optimizer_state_dict(copy.deepcopy(saved))
        make_train_step(back.model, back.cfg)(back, batches[2], 0)
        make_train_step(twin.model, twin.cfg)(twin, batches[2], 0)
        for p, q in zip(back.trainable, twin.trainable):
            assert torch.equal(p, q)


@pytest.mark.parametrize("flags", [["--steps_per_dispatch", "0"],
                                   ["--profile_dir", "x", "--profile_steps", "0"]])
def test_train_cli_refuses_bad_dispatch_and_profile_counts(flags, tmp_path):
    with pytest.raises(SystemExit):
        torch_train_cli.main(CLI + ["--output_dir", str(tmp_path), *flags])
