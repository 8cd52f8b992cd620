"""Typed experiment configuration mirroring the reference YAML schema.

A copy of aladin_tpu/config.py (the port imports nothing from aladin_tpu),
except that ``load_config`` also reads JSON and imports ``yaml`` only for a
``.yaml``/``.yml`` path.

The reference drives experiments with a YAML file (ref:alad/configs/*.yaml,
schema documented in SURVEY.md S2.2) layered under ~50 argparse flags
(ref:alad/train.py:40-168). Here the YAML schema is reproduced verbatim
(dash-separated keys) and parsed into frozen dataclasses; the flag layer
becomes :class:`DataArgs`.

Reference defects handled explicitly (SURVEY.md S2.6):
  * #3 - the shipped YAMLs write ``activate_distillation_after`` (underscore)
    but the reference loop reads ``activate-distillation-after`` and silently
    falls back to 0.  We accept BOTH spellings, preferring the dashed one,
    so both the shipped files and the documented key work.
  * #1 - ``warmup: 'linear'`` crashes in the reference (module never
    imported); here it is implemented (see train/schedule.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple, Union



def _get(d: Dict[str, Any], key: str, default: Any = None) -> Any:
    """Look up ``key`` accepting both dash and underscore spellings."""
    if key in d:
        return d[key]
    alt = key.replace("-", "_") if "-" in key else key.replace("_", "-")
    return d.get(alt, default)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """``model:`` section (ref:alad/configs/alad-alignment-and-matching-distill.yaml:4-17)."""

    name: str = "teran"
    embed_size: int = 768
    text_aggregation: Optional[str] = "first"
    image_aggregation: Optional[str] = "first"
    freeze_teran: bool = False
    teran_layers: int = 0
    tern_layers: int = 2
    post_layers: int = 0
    exclude_stopwords: bool = False
    shared_transformer: bool = True
    # False | 'mean' | 'gated' | 'transformer' (ref:alad/alad_model.py:59-66)
    depth_aggregation_alignment: Union[bool, str] = False
    depth_aggregation_matching: Union[bool, str] = False
    dropout: float = 0.1
    # TPU-native: backbone FFN activation. 'gelu' = exact erf (reference /
    # released-checkpoint parity). 'gelu-tanh' = tanh approximation —
    # chip-measured ~10-15% faster per B=128 train step (the erf BACKWARD
    # is transcendental-bound on the VPU); use for from-scratch training.
    hidden_act: str = "gelu"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        return cls(
            name=_get(d, "name", "teran"),
            embed_size=_get(d, "embed-size", 768),
            text_aggregation=_get(d, "text-aggregation", "first"),
            image_aggregation=_get(d, "image-aggregation", "first"),
            freeze_teran=bool(_get(d, "freeze-teran", False)),
            teran_layers=int(_get(d, "teran-layers", 0)),
            tern_layers=int(_get(d, "tern-layers", 2)),
            post_layers=int(_get(d, "post-layers", 0)),
            exclude_stopwords=bool(_get(d, "exclude-stopwords", False)),
            shared_transformer=bool(_get(d, "shared-transformer", True)),
            depth_aggregation_alignment=_get(d, "depth-aggregation-alignment", False),
            depth_aggregation_matching=_get(
                d, "depth-aggregation-matching", _get(d, "depth-aggregation", False)
            ),
            dropout=float(_get(d, "dropout", 0.1)),
            hidden_act=str(_get(d, "hidden-act", "gelu")).replace("-", "_"),
        )


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """``training:`` section (ref:alad/configs/*.yaml:19-36, SURVEY.md S2.2)."""

    lr: float = 1e-5
    grad_clip: float = 2.0
    max_violation: bool = True
    # dash-joined tokens of {alignment, matching, distillation, attdistillation,
    # selfaggregation, entropy, regularizehidden} (ref:alad/alad_model.py:265)
    loss_type: str = "alignment"
    # list of per-loss weights, or 'auto' for learned uncertainty weighting
    # (ref:alad/alad_model.py:266-273)
    loss_weights: Union[List[float], str] = dataclasses.field(default_factory=lambda: [1.0])
    # 'sum'|'mean'|'MrSw'|'MrAVGw'|'symm'|'MwSr'|'scan-sentences'
    # (ref:alad/loss.py:120-149)
    alignment_mode: str = "MrSw"
    # 'mse'|'ordinal'|'contrastive'|'listnet' (ref:alad/loss.py:359-447)
    distillation_mode: str = "listnet"
    activate_distillation_after: int = 0
    measure: str = "dot"  # 'dot' | 'cosine' | 'order'
    # TPU-native: chunk the in-batch alignment tensor over the caption axis
    # (rematerialized in backward); 0 = dense. Unlocks B >= 512.
    alignment_chunk: int = 0
    # TPU-native: run the encoder as a checkpointed scan over microbatches
    # (loss still sees the full batch); 0 = one big forward. Unlocks B >= 1024
    # on one chip (train/step.py encode_microbatched).
    encoder_microbatch: int = 0
    # TPU-native: PRNG used for dropout masks — 'auto' = hardware 'rbg' on
    # TPU (threefry mask generation is ~24% of the B=128 step), 'threefry'
    # elsewhere / for bitwise cross-topology reproducibility (utils/rng.py)
    rng_impl: str = "auto"
    margin: float = 0.2
    bs: int = 32
    scheduler: Optional[str] = "steplr"  # 'steplr' | None
    gamma: float = 0.1
    step_size: int = 15
    warmup: Optional[str] = None  # 'linear' | None
    warmup_period: int = 1000

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainingConfig":
        return cls(
            lr=float(_get(d, "lr", 1e-5)),
            grad_clip=float(_get(d, "grad-clip", 2.0)),
            max_violation=bool(_get(d, "max-violation", True)),
            loss_type=_get(d, "loss-type", "alignment"),
            loss_weights=_get(d, "loss-weights", [1.0]),
            alignment_mode=_get(d, "alignment-mode", "MrSw"),
            distillation_mode=_get(d, "distillation-mode", "listnet"),
            activate_distillation_after=int(
                # dashed key wins (the key the reference loop reads,
                # ref:alad/train.py:196); underscore accepted (defect #3).
                d.get(
                    "activate-distillation-after",
                    d.get("activate_distillation_after", 0),
                )
            ),
            measure=_get(d, "measure", "dot"),
            alignment_chunk=int(_get(d, "alignment-chunk", 0)),
            encoder_microbatch=int(_get(d, "encoder-microbatch", 0)),
            rng_impl=_get(d, "rng-impl", "auto"),
            margin=float(_get(d, "margin", 0.2)),
            bs=int(_get(d, "bs", 32)),
            scheduler=_get(d, "scheduler", "steplr"),
            gamma=float(_get(d, "gamma", 0.1)),
            step_size=int(_get(d, "step-size", 15)),
            warmup=_get(d, "warmup", None),
            warmup_period=int(_get(d, "warmup-period", 1000)),
        )

    @property
    def loss_types(self) -> Tuple[str, ...]:
        """Active loss set: dash-split of loss-type (ref:alad/alad_model.py:265)."""
        return tuple(self.loss_type.split("-"))

    @property
    def auto_weight(self) -> bool:
        return not isinstance(self.loss_weights, list)

    def weight_for(self, loss_name: str) -> float:
        assert isinstance(self.loss_weights, list)
        mapping = dict(zip(self.loss_types, self.loss_weights))
        return float(mapping[loss_name])


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """``dataset:`` section."""

    name: str = "coco"
    data: str = "datasets"  # root dir for relevance matrices (ref:alad/evaluate_utils/dcg.py:11)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DatasetConfig":
        return cls(name=_get(d, "name", "coco"), data=_get(d, "data", "datasets"))


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    raw: Optional[Dict[str, Any]] = None  # round-tripped into checkpoints

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        return cls(
            dataset=DatasetConfig.from_dict(d.get("dataset", {})),
            model=ModelConfig.from_dict(d.get("model", {})),
            training=TrainingConfig.from_dict(d.get("training", {})),
            raw=d,
        )

    def to_dict(self) -> Dict[str, Any]:
        if self.raw is not None:
            return self.raw
        return {
            "dataset": {"name": self.dataset.name, "data": self.dataset.data},
            "model": {
                "name": self.model.name,
                "embed-size": self.model.embed_size,
                "text-aggregation": self.model.text_aggregation,
                "image-aggregation": self.model.image_aggregation,
                "freeze-teran": self.model.freeze_teran,
                "teran-layers": self.model.teran_layers,
                "tern-layers": self.model.tern_layers,
                "post-layers": self.model.post_layers,
                "exclude-stopwords": self.model.exclude_stopwords,
                "shared-transformer": self.model.shared_transformer,
                "depth-aggregation-alignment": self.model.depth_aggregation_alignment,
                "depth-aggregation-matching": self.model.depth_aggregation_matching,
                "dropout": self.model.dropout,
                "hidden-act": self.model.hidden_act,
            },
            "training": {
                "lr": self.training.lr,
                "grad-clip": self.training.grad_clip,
                "max-violation": self.training.max_violation,
                "loss-type": self.training.loss_type,
                "loss-weights": self.training.loss_weights,
                "alignment-mode": self.training.alignment_mode,
                "distillation-mode": self.training.distillation_mode,
                "activate-distillation-after": self.training.activate_distillation_after,
                "measure": self.training.measure,
                "alignment-chunk": self.training.alignment_chunk,
                "encoder-microbatch": self.training.encoder_microbatch,
                "rng-impl": self.training.rng_impl,
                "margin": self.training.margin,
                "bs": self.training.bs,
                "scheduler": self.training.scheduler,
                "gamma": self.training.gamma,
                "step-size": self.training.step_size,
                "warmup": self.training.warmup,
                "warmup-period": self.training.warmup_period,
            },
        }


def load_config(path: str) -> ExperimentConfig:
    """A recipe file, JSON or YAML (by extension)."""
    with open(path, "r") as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            d = yaml.safe_load(f)
        else:
            d = json.load(f)
    return ExperimentConfig.from_dict(d)


@dataclasses.dataclass
class DataArgs:
    """The argparse-flag layer shared by train/test (ref:alad/train.py:40-168).

    Only the flags the ALADIN pipeline actually consumes are kept; legacy
    OSCAR-task flags are out of scope for the data path.
    """

    data_dir: str = "datasets/coco_ir"
    img_feat_file: str = "datasets/coco_ir/features.tsv"
    eval_model_dir: str = ""  # OSCAR/VinVL checkpoint dir (also tokenizer source)
    output_dir: str = "output/"
    logger_name: str = "runs/runX"

    max_seq_length: int = 70
    max_img_seq_length: int = 50
    img_feature_dim: int = 2054
    img_feature_type: str = "frcnn"
    use_img_layernorm: int = 1
    img_layer_norm_eps: float = 1e-12
    add_od_labels: bool = False
    od_label_type: str = "vg"
    att_mask_type: str = "CLR"
    do_lower_case: bool = True

    num_captions_per_img_train: int = 5
    num_captions_per_img_val: int = 5
    eval_img_keys_file: str = ""
    eval_caption_index_file: str = ""

    per_gpu_train_batch_size: int = 32
    per_gpu_eval_batch_size: int = 64
    num_workers: int = 4
    seed: int = 88

    num_epochs: int = 20
    log_step: int = 10
    val_step: int = 500
    resume: str = ""
    load_teacher_model: str = ""
    reinitialize_scheduler: bool = False
    config: str = ""

    # TPU-native additions
    mesh_shape: str = "dp=-1"  # e.g. "dp=4,tp=2"; -1 = all remaining devices
    compute_dtype: str = "bfloat16"
    synthetic: bool = False  # tiny on-disk dataset + random small backbone
    profile_dir: str = ""  # JAX profiler trace of the first post-compile steps
    profile_steps: int = 5
    steps_per_dispatch: int = 1  # K train steps per host dispatch (lax.scan window)
    ndcg: bool = False  # NDCG@25 from precomputed relevance matrices
    int8_encoder: bool = False  # W8A8 encoder matmuls (eval/serving only)
