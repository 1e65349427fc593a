"""Configuration dataclasses for the pipeline: a verbatim copy of
``tpumcia.config``, so that one config file drives either package.

The reference keeps every parameter as a literal inside notebook cells
(SURVEY.md §5: data dir at ipynb:66, test_size=0.25 at :386, importance
threshold 0.01 at :459, n_repeats=10 / random_state=42 at :495-496, GLCM
distances=[5], angles=[0], levels=256 at :298). Its `.gitignore` hints at a
planned `configs/sample_config.json`. Here those become one JSON-serialisable
config tree whose defaults equal the notebook literals.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass(frozen=True)
class GLCMConfig:
    """Gray-level co-occurrence texture settings (reference ipynb:298).

    ``distance``/``angle`` accept a single value or a tuple (the skimage
    ``distances=[..], angles=[..]`` list API — offsets are the cross
    product). With a single (distance, angle) pair, feature names keep the
    reference's plain ``contrast_Ch1`` form; with several, each pair gets a
    ``_d{d}a{deg}`` tag.
    """

    distance: int | tuple = 5
    angle: float | tuple = 0.0  # radians; offset = (round(d*sin a), round(d*cos a))
    levels: int = 256

    @property
    def distances(self) -> tuple:
        d = self.distance
        return tuple(d) if isinstance(d, (tuple, list)) else (d,)

    @property
    def angles(self) -> tuple:
        a = self.angle
        return tuple(a) if isinstance(a, (tuple, list)) else (a,)

    @property
    def offsets(self) -> list[tuple[int, int]]:
        import math

        return [
            (int(round(math.sin(a) * d)), int(round(math.cos(a) * d)))
            for d in self.distances
            for a in self.angles
        ]

    @property
    def pair_labels(self) -> list[str] | None:
        """None for a single offset (legacy names); else one tag per pair."""
        if len(self.distances) == 1 and len(self.angles) == 1:
            return None
        import math

        return [
            f"d{d}a{int(round(math.degrees(a)))}"
            for d in self.distances
            for a in self.angles
        ]

    @property
    def offset(self) -> tuple[int, int]:
        return self.offsets[0]


@dataclass(frozen=True)
class FeatureConfig:
    """Feature-extraction settings."""

    glcm: GLCMConfig = field(default_factory=GLCMConfig)
    include_intensity: bool = True
    include_glcm: bool = True
    # moment-based mask shape features (needs a mask; framework extension —
    # the reference computes no morphology, see features/morphology.py)
    include_morphology: bool = False
    # 'hybrid': device scalar-reduction + host f64 assembly — exact for
    #          large-magnitude features, ~1e-7 relative on f32-summed ones
    #          (well inside the 1e-5 MAE target); the recommended default.
    # 'exact': full histograms to host, float64 finalize there (matches the
    #          reference formulas to ~1e-9; O(B*C*L) host work).
    # 'device': everything on-device in float32 (for fully device-resident
    #          streaming; ~1e-6 relative accuracy).
    precision: str = "hybrid"
    # images per vmapped chunk inside the jitted scan (memory/throughput knob)
    chunk_size: int = 32
    # dtype for the one-hot matmuls; bfloat16 is exact for 0/1 values and the
    # f32 MXU accumulator keeps counts exact, at half the HBM footprint.
    onehot_dtype: str = "bfloat16"
    use_pallas: str = "auto"  # 'auto' | 'always' | 'never'


@dataclass(frozen=True)
class HeadConfig:
    """Classifier-head settings (reference: RandomForestClassifier() defaults
    at ipynb:404; the logistic head is the device-resident alternative
    sanctioned by BASELINE.json config 2)."""

    kind: str = "logistic"  # 'logistic' | 'mlp' | 'random_forest'
    # logistic / mlp heads
    learning_rate: float = 0.05
    num_steps: int = 500
    l2: float = 1e-4
    hidden: tuple = (64,)  # mlp hidden layer widths
    # random forest head (sklearn adapter)
    n_estimators: int = 100
    max_depth: int | None = None
    seed: int = 0


@dataclass(frozen=True)
class ImportanceConfig:
    """Channel/feature importance settings (reference ipynb:458-462, 495-496)."""

    n_repeats: int = 10
    seed: int = 42
    mdi_threshold: float = 0.01  # per-feature floor in channel aggregation
    # 'exact' matches features to channels by parsed channel index;
    # 'substring' replicates the reference's `"Ch1" in name` matching, which
    # breaks for >= 10 channels (SURVEY.md §3.3).
    channel_match: str = "exact"
    # how run_pipeline scores channels: 'permutation' (reference default,
    # ipynb:493-505), 'ablation' (column fill-in score drop), 'mdi'/'coef'
    # (head-derived; head kind must match), or 'auto' (mdi for forests,
    # permutation otherwise). See importance/channels.py::channel_importance.
    channel_method: str = "permutation"


@dataclass(frozen=True)
class SplitConfig:
    """Train/test split. The reference split is unseeded and unstratified
    (ipynb:386); ours is seeded, with optional stratification and grouped
    (per-donor / per-experiment) splitting for the h5 contract."""

    test_size: float = 0.25
    seed: int = 0
    stratify: bool = False
    group_by: str | None = None  # None | 'donor' | 'experiment'


@dataclass(frozen=True)
class SynthConfig:
    """On-device noise-channel synthesis (the reference's
    ``add_two_noise_channels``, ipynb:148-156, seeded). With
    ``noise_channels > 0`` the pipeline accepts (B, H, W) grayscale input and
    synthesizes the extra channels on device — fused into the per-batch
    extraction dispatch on the fast path."""

    noise_channels: int = 0  # 0 = input arrives multichannel already
    var: float = 0.01
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. data: batch sharding; model: parameter sharding
    for the CNN path. Sizes of -1 mean "all remaining devices"."""

    data: int = -1
    model: int = 1


@dataclass(frozen=True)
class PipelineConfig:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    importance: ImportanceConfig = field(default_factory=ImportanceConfig)
    split: SplitConfig = field(default_factory=SplitConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    synth: SynthConfig = field(default_factory=SynthConfig)
    normalize: str = "minmax"  # feature-matrix scaling before the head
    seed: int = 0
    # fused fast path (device-resident features + one-dispatch head/sweeps):
    # 'auto' uses it for large single-device logistic/minmax runs, 'always'
    # forces it (tests/benchmarks), 'never' disables it.
    fast_path: str = "auto"
    batch_size: int = 2048  # fixed extraction batch shape on the fast path

    # ------------------------------------------------------------------ io
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str | Path | None = None) -> str:
        text = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            Path(path).write_text(text)
        return text

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "PipelineConfig":
        return build_config(cls, data)

    @classmethod
    def from_json(cls, path: str | Path) -> "PipelineConfig":
        return cls.from_dict(json.loads(Path(path).read_text()))


def coerce_config(config) -> "PipelineConfig":
    """Accept the forms the entry points document: a ``PipelineConfig``, a
    plain (possibly partial) dict for it, or None for defaults."""
    if config is None:
        return PipelineConfig()
    if isinstance(config, PipelineConfig):
        return config
    if isinstance(config, dict):
        return PipelineConfig.from_dict(config)
    raise TypeError(
        "config must be a PipelineConfig, a dict, or None; got "
        f"{type(config).__name__}"
    )


_SUBTYPES = {
    "features": FeatureConfig,
    "head": HeadConfig,
    "importance": ImportanceConfig,
    "split": SplitConfig,
    "mesh": MeshConfig,
    "glcm": GLCMConfig,
    "synth": SynthConfig,
}


def build_config(tp, data: dict[str, Any], path: str = "config"):
    """Reconstruct a config dataclass (and nested sub-configs) from a plain
    dict — the shared machinery behind ``PipelineConfig.from_dict`` and the
    ``FeatureMatrix``/head checkpoint round-trips. Rejects unknown keys;
    JSON lists become tuples (all sequence-valued config fields are
    tuples)."""
    if not dataclasses.is_dataclass(tp):
        return data
    known = {f.name for f in dataclasses.fields(tp)}
    unknown = set(data) - known
    if unknown:
        raise ValueError(
            f"unknown {path} key(s) {sorted(unknown)}; "
            f"valid keys: {sorted(known)}"
        )
    kwargs = {}
    for f in dataclasses.fields(tp):
        if f.name in data:
            val = data[f.name]
            if isinstance(val, dict):
                sub_tp = _SUBTYPES.get(f.name)
                kwargs[f.name] = (
                    build_config(sub_tp, val, f"{path}.{f.name}")
                    if sub_tp
                    else val
                )
            elif isinstance(val, list):
                kwargs[f.name] = tuple(val)
            else:
                kwargs[f.name] = val
    return tp(**kwargs)
