"""MinMax feature scaling on the device (the reference's sklearn
``MinMaxScaler``, ipynb:389-394; counterpart of ``tpumcia.models.scaler``).
Zero-range features get scale 1, as sklearn's ``_handle_zeros_in_scale``
gives them."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpumcia_torch.utils.device import require_device


def minmax_scale(data_min: torch.Tensor, data_max: torch.Tensor) -> torch.Tensor:
    """1 / (max - min), and 1 where the range is zero."""
    rng = data_max - data_min
    return torch.where(rng != 0, 1.0 / torch.where(rng != 0, rng, 1.0), 1.0)


@dataclass(frozen=True)
class MinMaxScaler:
    data_min: torch.Tensor  # (F,)
    data_max: torch.Tensor  # (F,)

    @classmethod
    def fit(cls, X: torch.Tensor) -> "MinMaxScaler":
        # NaNs are ignored, as sklearn's fit ignores them
        nan = torch.isnan(X)
        return cls(
            data_min=torch.where(nan, torch.inf, X).amin(0),
            data_max=torch.where(nan, -torch.inf, X).amax(0),
        )

    @classmethod
    def from_stats(cls, data_min, data_max, device="cuda") -> "MinMaxScaler":
        """A scaler from per-feature min/max (arrays or tensors), on
        ``device``."""
        require_device(device, "MinMaxScaler.from_stats")

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return cls(t(data_min), t(data_max))

    @property
    def scale(self) -> torch.Tensor:
        return minmax_scale(self.data_min, self.data_max)

    def transform(self, X: torch.Tensor) -> torch.Tensor:
        return (X - self.data_min) * self.scale

    def inverse_transform(self, X: torch.Tensor) -> torch.Tensor:
        rng = self.data_max - self.data_min
        return X * torch.where(rng != 0, rng, 1.0) + self.data_min

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {
            "data_min": self.data_min.detach().cpu().numpy(),
            "data_max": self.data_max.detach().cpu().numpy(),
        }
