"""Classifier heads, the scaler, the device forest and the CNN
(counterpart of ``tpumcia.models``, with its exports)."""

from tpumcia_torch.models.forest_device import DeviceForest
from tpumcia_torch.models.heads import LogisticHead, MLPHead, RandomForestHead, fit_head
from tpumcia_torch.models.scaler import MinMaxScaler

__all__ = [
    "fit_head",
    "LogisticHead",
    "MLPHead",
    "RandomForestHead",
    "MinMaxScaler",
    "DeviceForest",
]
