"""Feature extraction (counterpart of ``tpumcia.features``, with its
exports): the 23-per-channel intensity + GLCM feature matrix, morphology,
co-occurrence matrices and their properties. The GLCM statistics come from
``cuda_glcm`` (the CUDA kernel ``csrc/glcm_stats.cu`` and its plain
version)."""

from tpumcia_torch.features.extract import (
    FeatureMatrix,
    extract_features,
    extract_features_batched,
)
from tpumcia_torch.features.morphology import morphology_features
from tpumcia_torch.features.props import glcm_properties
from tpumcia_torch.features.registry import feature_names, num_features
from tpumcia_torch.features.stats import glcm_matrix

__all__ = [
    "extract_features",
    "extract_features_batched",
    "FeatureMatrix",
    "feature_names",
    "num_features",
    "morphology_features",
    "glcm_properties",
    "glcm_matrix",
]
