"""Pure CPU numpy/scipy oracle reproducing the reference notebook's feature
semantics (a copy of ``tpumcia.reference_impl``, with its exports).

The tests and ``chip_smoke.py`` hold the port's finished features against
it. See SURVEY.md §2.3 for the exact contract (reference:
channel_importance_hand_crafted_features.ipynb, cells 9 and 13).
"""

from tpumcia_torch.reference_impl.oracle import (
    add_noise_channels,
    basic_statistical_features,
    feature_names,
    feature_vector,
    glcm_features,
    graycomatrix,
    graycoprops,
    shannon_entropy,
)

__all__ = [
    "add_noise_channels",
    "basic_statistical_features",
    "feature_names",
    "feature_vector",
    "glcm_features",
    "graycomatrix",
    "graycoprops",
    "shannon_entropy",
]
