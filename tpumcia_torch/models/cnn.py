"""ResNet-18-style CNN classifier with a C-channel input stem (counterpart
of ``tpumcia.models.cnn``, BASELINE config 3: the learned-feature path for
multichannel cell images).

The same network as tpumcia's flax module, layer for layer, so that one set
of weights runs in both packages (:func:`state_dict_from_flax`,
:func:`flax_params_from_state_dict`):

* a 3x3 stride-1 stem without max-pool (inputs are 64x64 cell crops), four
  stages of residual blocks at widths ``width * 2**stage``, the first block
  of stages 1-3 at stride 2, a global mean pool and a float32 classifier;
* GroupNorm everywhere (no batch statistics), ``eps=1e-6`` as flax has it
  (``nn.GroupNorm`` defaults to 1e-5), with :func:`_num_groups` groups;
* flax's ``padding="SAME"``: computed from the input size as XLA computes it,
  so a stride-2 3x3 convolution on an even size pads (0, 1), not (1, 1);
* float32 parameters; compute in bfloat16 under ``torch.autocast`` (tpumcia's
  ``dtype=bfloat16``), or in float32 with ``dtype=torch.float32`` (whose
  ``.double()`` copy computes in float64: a reference for checks).

Input is (B, H, W, C) float in [0, 1], tpumcia's layout; inside it becomes
an NCHW view of the same memory, which is PyTorch's ``channels_last``, so
nothing is copied. The convolutions, the norms and the dense layer are
PyTorch's own operators (cuDNN on a CUDA device), as they are XLA's in
tpumcia: no hand-written kernel takes part on this path.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

STAGE_SIZES = {"10": (1, 1, 1, 1), "18": (2, 2, 2, 2), "34": (3, 4, 6, 3)}
GROUP_NORM_EPS = 1e-6  # flax.linen.GroupNorm's default


def _num_groups(features: int) -> int:
    """Largest group count <= 32 dividing ``features`` (a copy of
    ``tpumcia.models.cnn._num_groups``)."""
    g = min(32, features)
    while features % g:
        g -= 1
    return g


def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's SAME rule along one dimension: the
    output has ceil(size / stride) positions, and the odd unit of padding
    goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A bias-free convolution with flax's ``padding="SAME"``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = _same_pads(x.shape[2], k, s)
        left, right = _same_pads(x.shape[3], k, s)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, None, self.stride, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, None, self.stride, 0)


def _group_norm(features: int) -> nn.GroupNorm:
    return nn.GroupNorm(_num_groups(features), features, eps=GROUP_NORM_EPS)


class ResidualBlock(nn.Module):
    """conv1 - norm - relu - conv2 - norm, plus the input (through a 1x1
    ``proj`` convolution and a norm where its shape changes), then relu. The
    norms carry flax's automatic names."""

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(in_features, features, 3, strides)
        self.GroupNorm_0 = _group_norm(features)
        self.conv2 = SameConv2d(features, features, 3)
        self.GroupNorm_1 = _group_norm(features)
        self.has_proj = strides != 1 or in_features != features
        if self.has_proj:
            self.proj = SameConv2d(in_features, features, 1, strides)
            self.GroupNorm_2 = _group_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(self.conv1(x)))
        y = self.GroupNorm_1(self.conv2(y))
        residual = self.GroupNorm_2(self.proj(x)) if self.has_proj else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """(B, H, W, C) float images in [0, 1] -> (B, num_classes) float32
    logits."""

    def __init__(self, num_classes: int, *, in_channels: int, stage_sizes=(2, 2, 2, 2),
                 width: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dtype must be torch.bfloat16 or torch.float32; got {dtype}")
        self.num_classes, self.in_channels = num_classes, in_channels
        self.stage_sizes, self.width, self.dtype = tuple(stage_sizes), width, dtype
        self.stem = SameConv2d(in_channels, width, 3)
        self.GroupNorm_0 = _group_norm(width)
        self.block_names: list[str] = []
        features_in = width
        for stage, num_blocks in enumerate(self.stage_sizes):
            features = width * 2**stage
            for block in range(num_blocks):
                name = f"stage{stage}_block{block}"
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(name, ResidualBlock(features_in, features, strides))
                self.block_names.append(name)
                features_in = features
        self.classifier = nn.Linear(features_in, num_classes)

    def _compute(self, device_type: str):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type, dtype=torch.bfloat16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != self.in_channels:
            raise ValueError(
                f"expected (B, H, W, {self.in_channels}) images; got shape {tuple(x.shape)}")
        # NHWC memory seen as NCHW: channels_last, no copy; cast to the
        # parameters' type (float32, or float64 in a ``.double()`` reference)
        x = x.to(self.classifier.weight.dtype).permute(0, 3, 1, 2)
        with self._compute(x.device.type):
            x = F.relu(self.GroupNorm_0(self.stem(x)))
            for name in self.block_names:
                x = getattr(self, name)(x)
            x = x.mean(dim=(2, 3))  # global average pool
        with torch.autocast(x.device.type, enabled=False):
            return self.classifier(x.to(self.classifier.weight.dtype))  # the classifier is never bf16


def make_resnet(num_classes: int, *, in_channels: int, width: int = 64, depth: str = "18",
                dtype: torch.dtype = torch.bfloat16) -> ResNet:
    """tpumcia's ``make_resnet``; ``in_channels`` is explicit because a
    PyTorch module has its shapes before it sees data."""
    return ResNet(num_classes, in_channels=in_channels, stage_sizes=STAGE_SIZES[depth],
                  width=width, dtype=dtype)


# flax's lecun_normal draws from a normal truncated at +-2 sigma and divides
# by that distribution's standard deviation, so the result has variance 1/fan_in
_TRUNCATED_STD = 0.87962566103423978


def init_parameters(model: ResNet, generator: torch.Generator) -> None:
    """tpumcia's initial distributions, drawn from ``generator`` (a CPU
    generator: the same seed gives the same weights on any device): lecun
    normal convolutions and dense kernel (truncated normal, variance 1 /
    fan_in), unit norm scales, zero biases. The values are not tpumcia's
    threefry draws."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                w = module.weight
                fan_in = w[0].numel()  # in_channels * kh * kw, or in_features
                std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
                # a normal truncated at +-2 sigma by the inverse CDF of uniforms
                lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
                u = torch.rand(w.shape, dtype=torch.float64, generator=generator)
                draw = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
                w.copy_((std * draw).clamp_(-2 * std, 2 * std).to(torch.float32))
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.GroupNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()


# --- weights carried between the packages ------------------------------------


def state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """tpumcia's flax parameter tree (nested dicts, leaves array-like) ->
    this module's ``state_dict``: convolution kernels HWIO -> OIHW, the dense
    kernel (in, out) -> (out, in), norm ``scale`` -> ``weight``; the names are
    the same path joined by dots."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict) or hasattr(value, "items"):
                walk(value, path + [key])
                continue
            a = np.asarray(value)
            if key == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = "weight"
            else:
                name = "weight" if key == "scale" else key
            out[".".join(path + [name])] = torch.from_numpy(np.array(a))  # a writable copy

    walk(params, [])
    return out


def flax_params_from_state_dict(state_dict) -> dict:
    """The inverse of :func:`state_dict_from_flax`: nested dicts of numpy
    arrays that ``tpumcia.models.cnn.ResNet.apply({"params": ...})`` takes."""
    params: dict = {}
    for name, tensor in state_dict.items():
        *path, leaf = name.split(".")
        a = tensor.detach().cpu().numpy()
        if leaf == "weight":
            if a.ndim == 4:
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                leaf, a = "kernel", a.T
            else:
                leaf = "scale"
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(a)
    return params
