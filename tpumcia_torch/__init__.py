"""tpumcia_torch — the PyTorch/CUDA port of tpumcia for NVIDIA Hopper.

It runs tpumcia's ``run_pipeline`` on both of its paths: the fused fast
path on one device and the classic path that tpumcia takes for every other
configuration, which also runs over a device mesh (``parallel``: the
statistics, the scaler's min/max and the permutation sweeps over the mesh's
data slots, within a process or across the ranks of a ``torch.distributed``
group). Seeded noise-channel synthesis or masked multichannel input,
the 23-per-channel intensity + GLCM feature matrix (GLCM statistics from a
hand-written CUDA kernel, ``csrc/glcm_stats.cu``, below 2^24 pixels and up
to 32768 levels) with per-channel mask morphology as an option, a logistic,
MLP or random-forest head (``fit_head``; the forest is grown on the device
with sklearn's semantics and no sklearn), and channel importance by MDI,
permutation, per-feature permutation, ablation or coefficients
(``channel_importance``). ``extract_features`` runs tpumcia's
single-device extraction in every precision (hybrid, exact, device), masked
or not, at one GLCM offset or several; ``glcm_matrix`` and
``glcm_properties`` give the co-occurrence matrices and their skimage
properties. ``load_objects`` reads per-object HDF5 files into an
``ObjectBatch`` and ``analyze_objects`` runs the whole analysis on one;
``pipeline.streaming.stream_extract`` (and ``stream_extract_h5``) extracts
a collection of any size in resumable shards, with a bounded share of it on
the device. The CNN path is ``models.cnn`` (a ResNet with a C-channel stem),
``models.train.fit_cnn``, ``importance.occlusion`` and
``pipeline.run_cnn.run_cnn_pipeline``, on one device or data-parallel over a
mesh (``parallel.data_parallel``); ``python -m tpumcia_torch.eval`` is the
config-driven command line, with ``reports.plots`` and ``utils.profiling``
behind it (``--distributed`` across processes), and
``python -m tpumcia_torch.examples.<name>`` runs tpumcia's five examples.
Module paths, function names and signatures mirror ``tpumcia``, so
tpumcia's calls run unchanged (``tests/test_torch_api_parity.py``; the
divergences left are listed in ROADMAP); ``reference_impl`` is a copy of
its notebook oracle. Every entry point runs on the card unless the caller
passes ``device="cpu"`` (each kernel's plain version); without a card the
default raises ``utils.device.NoCUDADevice``. It imports neither ``jax``
(nor ``flax``, ``optax``, ``orbax``) nor ``tpumcia`` nor ``sklearn``.

    >>> import tpumcia_torch as tt
    >>> res = tt.run_pipeline(gray, labels, config=tt.PipelineConfig(
    ...     synth=tt.SynthConfig(noise_channels=2), fast_path="always"))
    >>> res.channel_result.ranking
"""

from tpumcia_torch.version import __version__
from tpumcia_torch.api import analyze_objects, feature_importance, load_objects
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
from tpumcia_torch.features.morphology import morphology_features
from tpumcia_torch.features.props import glcm_properties
from tpumcia_torch.features.registry import feature_names, num_features
from tpumcia_torch.features.stats import glcm_matrix
from tpumcia_torch.importance.channels import channel_importance
from tpumcia_torch.models.heads import RandomForestHead, fit_head
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
    "feature_names",
    "num_features",
    "morphology_features",
    "glcm_properties",
    "glcm_matrix",
    "fit_head",
    "RandomForestHead",
    "channel_importance",
    "PipelineResult",
    "run_pipeline",
    "quantize_to_levels",
    "load_objects",
    "analyze_objects",
    "feature_importance",
]
