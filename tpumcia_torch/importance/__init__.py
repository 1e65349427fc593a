"""Channel and feature importance (counterpart of ``tpumcia.importance``,
with its exports): permutation, ablation, MDI, coefficients and the CNN's
occlusion probes."""

from tpumcia_torch.importance.ablation import channel_ablation_importance
from tpumcia_torch.importance.channels import (
    ChannelImportanceResult,
    aggregate_channel_importance,
    channel_importance,
)
from tpumcia_torch.importance.permutation import PermutationResult, permutation_importance

__all__ = [
    "permutation_importance",
    "PermutationResult",
    "aggregate_channel_importance",
    "channel_importance",
    "ChannelImportanceResult",
    "channel_ablation_importance",
]
