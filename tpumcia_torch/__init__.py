"""tpumcia_torch — the PyTorch/CUDA port of tpumcia for NVIDIA Hopper.

It runs tpumcia's ``run_pipeline`` on one device, on both of its paths: the
fused fast path and the classic path that tpumcia takes for every other
configuration. Seeded noise-channel synthesis or masked multichannel input,
the 23-per-channel intensity + GLCM feature matrix (GLCM statistics from a
hand-written CUDA kernel, ``csrc/glcm_stats.cu``, at any image size and up
to 4096 levels), a logistic or MLP head (``fit_head``), and channel
importance by permutation, per-feature permutation, ablation or
coefficients (``channel_importance``). ``extract_features`` runs tpumcia's
single-device extraction in every precision (hybrid, exact, device), masked
or not, at one GLCM offset or several. Not ported yet: the random-forest
head and MDI, morphology, h5 ingestion, streaming, the CNN, multi-GPU and
the CLI (ROADMAP).
Module paths and function names mirror ``tpumcia`` so each counterpart is
easy to find. It imports neither ``jax`` nor ``tpumcia``.

    >>> import tpumcia_torch as tt
    >>> res = tt.run_pipeline(gray, labels, device="cuda", config=tt.PipelineConfig(
    ...     synth=tt.SynthConfig(noise_channels=2), fast_path="always"))
    >>> res.channel_result.ranking
"""

from tpumcia_torch.version import __version__
from tpumcia_torch.config import (
    FeatureConfig,
    GLCMConfig,
    HeadConfig,
    ImportanceConfig,
    PipelineConfig,
    SplitConfig,
    SynthConfig,
)
from tpumcia_torch.features.extract import (
    FeatureMatrix,
    extract_features,
    extract_features_batched,
    extract_features_pending,
)
from tpumcia_torch.importance.channels import channel_importance
from tpumcia_torch.models.heads import fit_head
from tpumcia_torch.pipeline.run import PipelineResult, run_pipeline
from tpumcia_torch.preprocess.normalize import quantize_to_levels

__all__ = [
    "__version__",
    "FeatureConfig",
    "GLCMConfig",
    "HeadConfig",
    "ImportanceConfig",
    "PipelineConfig",
    "SplitConfig",
    "SynthConfig",
    "FeatureMatrix",
    "extract_features",
    "extract_features_batched",
    "extract_features_pending",
    "fit_head",
    "channel_importance",
    "PipelineResult",
    "run_pipeline",
    "quantize_to_levels",
]
