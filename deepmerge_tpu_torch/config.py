"""Configuration system.

Replaces the reference's hardcoded singleton (``config.py:9-34`` in
lvxianwei/DeepMerge) with typed dataclasses plus CLI/JSON overrides. All
hyperparameters that were edit-in-source in the reference (variant selection at
``Train_SMT.py:363-379``, margin/λ/β at ``:380-386``) are first-class fields.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Sequence

# Variants whose backbone is a stack of CrossScaleBlocks (the reference's
# nets/ShfitScaleFormer.py transformer stages). The block kernels — and
# therefore w8a8 quantized serving — exist only for these; v6 is the
# designed-features-only MLP ablation and "vit" is the ScaleEmbedTransformer
# adapter. Shared with models.s2former.build_model so the quantize no-op
# warning can never drift from the actual model dispatch.
CROSS_SCALE_BLOCK_VARIANTS = frozenset({"v1", "v2", "v3", "v4", "v5"})
KNOWN_VARIANTS = frozenset(CROSS_SCALE_BLOCK_VARIANTS | {"v6", "vit"})


class ExperimentalNegativeWarning(UserWarning):
    """Raised where the JAX package raises it: a config turns on one of
    its experimental knobs, which that package keeps as documented
    experiments, not as its defaults. Each message says what the knob
    measured on the H100 (PERF.md, with the card and its power limit),
    faster or slower."""


def _warn_experimental(knob: str, measurement: str) -> None:
    import warnings

    warnings.warn(
        f"{knob} is an experimental knob, not the default ({measurement}; "
        f"PERF.md).",
        ExperimentalNegativeWarning,
        stacklevel=3,
    )


# The measurements the warnings quote: chip_smoke.py on one NVIDIA H100
# 80GB HBM3 at a 700 W power limit, the flagship v3 at batch 1024 on a
# 1024² scene of 2048 regions (the slice), or 120 pairs a training step.
H100_SLICE = "NVIDIA H100 80GB HBM3, 700 W, v3 slice of a 1024² scene"
CHAIN_STAGE0_MEASURED = (
    "no faster on the H100, where a chain runs its blocks' launches one "
    "after another: 132.7 against 130.9 ms unchained in w8a8, 142.5 against "
    "142.3 in bf16 (NVIDIA H100 80GB HBM3, 700 W, trained v3 slice of a "
    "1024² scene)")


@dataclass(frozen=True)
class ModelConfig:
    """S2Former family configuration.

    Mirrors the knobs of the reference model family
    (``nets/ShfitScaleFormer.py``): variant selects v1..v6 behavior, the rest
    map 1:1 onto the reference constructor arguments. The shipped reference
    model is v3 with ``scales=[32,64,128]``, ``cube=8``, ``depth=(6,4,2)``
    (``Train_SMT.py:374``).
    """

    variant: str = "v3"                       # v1..v6 | "vit" (ScaleEmbedTransformer)
    input_image_scales: tuple[int, ...] = (32, 64, 128)
    cube: int = 8                             # stage-0 token grid side per scale
    embed_dim: int = 768
    depth: tuple[int, ...] = (6, 4, 2)        # per-stage depths (v1/v2: single int in [0])
    num_heads: int = 12
    mlp_ratio: float = 4.0
    out_dim: int = 100                        # embedding dimension (ref: Linear -> 100)
    num_classes: int = 11                     # optional classification head (ref head, unused in train)
    designed_feature_dim: int = 19            # 15 region attributes + 4 scale factors
    use_designed_features: bool = True        # is_designed_feature_embedding
    in_channels: int = 3
    drop_ratio: float = 0.0
    attn_drop_ratio: float = 0.0
    drop_path_ratio: float = 0.0
    dtype: str = "bfloat16"                   # compute dtype (params stay f32)
    fused_attention: bool = True              # attention kernel (inference path)
    fused_block: bool = True                  # whole-block kernels
                                              # (active when fused_attention
                                              # is on and all dropouts are 0)
    fused_stage_chain: bool = True            # a stage of blocks as one chain
                                              # launch (stages 1 and 2; needs
                                              # fused_block)
    chain_stage0: bool = False                # also chain stage 0 (6 blocks
                                              # at N 192) — experiment
    fused_block_bt: int = 2                   # the JAX kernel's batch tile
                                              # (no effect in the port)
    exact_gelu: bool = False                  # erf GELU (torch parity) vs tanh approx
                                              # (value diff <=3e-3, well inside
                                              # the 0.5% label-parity budget)
    quantize: str = ""                        # "" (bf16) or "w8a8": int8 GEMMs for
                                              # the block kernels' qkv/proj/mlp
                                              # (inference-only, needs the
                                              # fused-block path).
                                              # "w8a8+attn" / "w8a8-static" are
                                              # the JAX package's experiments
                                              # (warn on use);
                                              # "w8a8-static+attn" was pruned
                                              # there and is refused.

    def __post_init__(self):
        if self.quantize == "w8a8-static+attn":
            # pruned from the JAX package's config surface; refused as there
            raise ValueError(
                "model.quantize='w8a8-static+attn' was removed from the "
                "config surface, as in the JAX package. Use 'w8a8' (the "
                "serving default)."
            )
        if self.quantize not in ("", "w8a8", "w8a8+attn", "w8a8-static"):
            raise ValueError(
                f"model.quantize must be '', 'w8a8', 'w8a8+attn' or "
                f"'w8a8-static', got {self.quantize!r}"
            )
        if self.quantize == "w8a8+attn":
            _warn_experimental(
                "model.quantize='w8a8+attn'",
                f"slower than w8a8 on the H100: 147.9 against 139.8 ms "
                f"({H100_SLICE})",
            )
        elif self.quantize == "w8a8-static":
            _warn_experimental(
                "model.quantize='w8a8-static'",
                f"faster than w8a8 on the H100: 129.3 against 139.8 ms "
                f"({H100_SLICE}), at calibrated scales",
            )
        if self.chain_stage0:
            _warn_experimental("model.chain_stage0", CHAIN_STAGE0_MEASURED)
        if self.quantize and (
            not self.fused_block or not self.fused_attention
            or self.exact_gelu
            or self.variant not in CROSS_SCALE_BLOCK_VARIANTS
            or self.drop_ratio or self.attn_drop_ratio
            or self.drop_path_ratio
        ):
            import warnings

            warnings.warn(
                "model.quantize is set but the megakernel path is off "
                "(fused_block/fused_attention disabled, exact_gelu=True, "
                "a nonzero dropout ratio, or a variant without "
                "CrossScaleBlocks) — inference will run the bf16 path and "
                "quantize is a no-op"
            )

    @property
    def n_scales(self) -> int:
        return len(self.input_image_scales)

    @property
    def name(self) -> str:
        # Self-describing name, analog of nets/ShfitScaleFormer.py:791-796.
        if self.variant == "vit":
            tag = f"ScaleEmbedViT-{self.n_scales}CH"
        else:
            tag = f"S2Former_{self.variant}-{self.n_scales}CH"
        if self.use_designed_features:
            tag += "-3DP-SEF"
        depth = "".join(str(d) for d in self.depth)
        return f"{tag}-{depth}"


@dataclass(frozen=True)
class DataConfig:
    """Dataset / patch-pipeline configuration.

    ``patch_sizes`` are the fixed per-scale-slot resize targets (reference
    ``configs.scales=[32,64,128,1]`` at ``config.py:32``; the 4th slot is the
    scale-factor-only slot). ``max_window`` caps the adaptive crop window so
    gather + resize stay static-shaped under jit.
    """

    patch_sizes: tuple[int, ...] = (32, 64, 128)
    factor_slots: int = 4                     # factors vector length (ref get_scales -> 4)
    max_window: int = 512                     # static cap on adaptive window side
    channels: int = 3
    batch_size: int = 120                     # ref config.py:19 ("120 for 642")
    eval_batch_size: int = 2000               # ref ExtractFeatures.py:45
    quantize_uint8: bool = True               # emulate cv2-on-uint8 rounding before /255


@dataclass(frozen=True)
class TrainConfig:
    """Training loop configuration (reference ``Train_SMT.py:143-394``)."""

    num_epochs: int = 100
    lr: float = 1e-4
    lr_milestones: tuple[int, ...] = (40, 80)  # MultiStepLR epochs
    lr_gamma: float = 0.2
    margin: float = 1.0
    lamda: float = 0.1
    belta: float = 0.0
    seed: int = 0
    checkpoint_every: int = 5                 # epochs (ref Train_SMT.py:317)
    checkpoint_tail_from: int = 90            # every epoch >= this
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    resume: bool = False
    aux_weights: tuple[float, float] = (0.0, 0.0)
                                              # v4/v5 deep-supervision loss
                                              # weights (main + w0*aux1 +
                                              # w1*aux2). The reference keeps
                                              # this sum commented out with
                                              # weights 0.1/0.2
                                              # (Train_SMT.py:285-288);
                                              # default off to match what it
                                              # actually runs.
    fused_block: bool = False                 # train through the training
                                              # block kernel (K5) and its
                                              # hand backward: slower on the
                                              # H100 (238.0 against 161.9
                                              # ms/step at 120 pairs, 700 W);
                                              # autograd of the unfused
                                              # blocks stays the default.

    def __post_init__(self):
        if self.fused_block:
            _warn_experimental(
                "train.fused_block",
                "slower on the H100: 238.0 against 161.9 ms a step of 120 "
                "pairs (NVIDIA H100 80GB HBM3, 700 W): the saved-activation "
                "block and its hand backward lose to autograd",
            )


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for pjit sharding.

    The workload is embarrassingly batch-parallel (SURVEY.md §2.4): ``data``
    is the primary axis; ``model`` optionally shards attention heads / FFN
    hidden over ICI for scaled-up embed dims.
    """

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1                   # size of model axis (1 = pure DP)


@dataclass(frozen=True)
class MergeConfig:
    """Iterative merge engine configuration."""

    threshold: float = 1.0                    # merge edges with distance < threshold
    threshold_quantile: float | None = None   # if set, threshold = this quantile
                                              # of the initial edge distances
    max_rounds: int = 16
    edge_batch: int = 8192                    # padded edge-batch size per scoring call
    engine: str = "device"                    # "device" (one-dispatch label-prop) | "host" (union-find)

    def __post_init__(self):
        q = self.threshold_quantile
        if q is not None and not (0.0 <= q <= 1.0):
            raise ValueError(
                f"merge.threshold_quantile must be in [0, 1], got {q}"
            )


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    merge: MergeConfig = field(default_factory=MergeConfig)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)
        return Config(
            model=_from_dict(ModelConfig, raw.get("model", {})),
            data=_from_dict(DataConfig, raw.get("data", {})),
            train=_from_dict(TrainConfig, raw.get("train", {})),
            mesh=_from_dict(MeshConfig, raw.get("mesh", {})),
            merge=_from_dict(MergeConfig, raw.get("merge", {})),
        )


def _from_dict(cls: type, raw: dict) -> Any:
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in raw:
            v = raw[f.name]
            if isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
    return cls(**kw)


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``section.key=value`` CLI overrides, e.g. ``model.depth=6,4,2``."""
    out = cfg
    for item in overrides:
        key, _, val = item.partition("=")
        section_name, _, field_name = key.partition(".")
        if not hasattr(out, section_name) or not hasattr(
            getattr(out, section_name), field_name
        ):
            sections = [f.name for f in dataclasses.fields(out)]
            raise ValueError(
                f"unknown config key '{key}' (sections: {', '.join(sections)})"
            )
        section = getattr(out, section_name)
        old = getattr(section, field_name)
        new: Any
        if val.lower() in ("none", "null"):
            new = None
        elif isinstance(old, bool):
            new = val.lower() in ("1", "true", "yes")
        elif isinstance(old, tuple):
            elem = type(old[0]) if old else int
            new = tuple(elem(x) for x in val.split(","))
        elif old is None:
            # Optional field: infer numeric types, else keep the string
            if val.lower() in ("none", "null"):
                new = None
            else:
                try:
                    new = int(val)
                except ValueError:
                    try:
                        new = float(val)
                    except ValueError:
                        new = val
        else:
            new = type(old)(val)
        out = out.replace(**{section_name: dataclasses.replace(section, **{field_name: new})})
    return out
