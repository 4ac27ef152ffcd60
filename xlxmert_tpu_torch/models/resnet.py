"""ResNet-50/101 (port of xlxmert_tpu/models/resnet.py; torchvision's
structure).

Two roles, as in the JAX package:
  1. the perceptual-loss encoder of GAN training (reference
     ResNetEncoder, image_generator/src/layers.py:285-349, taps
     layer1..layer4; tasks/train_generator.py);
  2. the grid-feature backbone (`grid_features`: a 256x256 input gives a
     (8, 8, 2048) layer4 map), for the feature factory.

NCHW inside, `F.conv2d` for every convolution; the public forward takes
(B, H, W, 3) normalized images and returns the JAX layout ((B, H, W, C)
taps, views). BatchNorm is frozen: the running statistics (both roles
use the network frozen). Modules keep torchvision's names with flax's
folded indices (`layer1.0` is flax's `layer1_0`, `downsample.0` its
`downsample_0`; a BN's `weight` is flax's `scale`, its buffers `mean`
and `var` are the "batch_stats" collection), so `load_variables` takes
the JAX module's variables and a torchvision state dict converted by
core/convert.convert_torch_state_dict (`running_mean` -> `mean`).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class _BN(nn.Module):
    """Frozen BatchNorm on the running statistics: (x - mean) * (rsqrt(var
    + eps) * scale) + bias, the factor and the bias in the compute type,
    the mean subtracted in fp32 (the JAX module's type promotion)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + self.eps) * self.weight
        return ((x - self.mean[:, None, None])
                * inv.to(self.dtype)[:, None, None]
                + self.bias.to(self.dtype)[:, None, None])


class _Conv(nn.Module):
    """flax nn.Conv without a bias: padding k // 2 each side, in the
    compute type."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 strides: int = 1, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = strides, kernel // 2, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


class Bottleneck(nn.Module):
    def __init__(self, in_features: int, planes: int, strides: int = 1,
                 has_downsample: bool = False, dtype=torch.float32):
        super().__init__()
        out = planes * 4
        self.conv1 = _Conv(in_features, planes, 1, 1, dtype)
        self.bn1 = _BN(planes, dtype=dtype)
        self.conv2 = _Conv(planes, planes, 3, strides, dtype)
        self.bn2 = _BN(planes, dtype=dtype)
        self.conv3 = _Conv(planes, out, 1, 1, dtype)
        self.bn3 = _BN(out, dtype=dtype)
        self.downsample = (nn.ModuleList([
            _Conv(in_features, out, 1, strides, dtype),
            _BN(out, dtype=dtype)]) if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        res = x
        if self.downsample is not None:
            res = self.downsample[1](self.downsample[0](x))
        return F.relu(h + res)


class ResNet(nn.Module):
    """stage_sizes (3, 4, 6, 3) is resnet50, (3, 4, 23, 3) resnet101.
    forward(x, return_layers=False): x (B, H, W, 3) normalized -> logits
    (B, num_classes), or with return_layers a dict of the layer1..layer4
    taps (B, h, w, C), "pooled" and "logits"."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _Conv(3, 64, 7, 2, dtype)
        self.bn1 = _BN(64, dtype=dtype)
        planes, n_in = 64, 64
        for stage, n_blocks in enumerate(stage_sizes):
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(
                    n_in, planes, strides=(1 if stage == 0 or b else 2),
                    has_downsample=(b == 0), dtype=dtype))
                n_in = planes * 4
            setattr(self, f"layer{stage + 1}", nn.ModuleList(blocks))
            planes *= 2
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(n_in, num_classes)

    def forward(self, x: torch.Tensor, return_layers: bool = False):
        h = self.conv1(x.permute(0, 3, 1, 2))
        h = F.relu(self.bn1(h))
        h = F.max_pool2d(h, 3, 2, padding=1)   # -inf padding, as the JAX
        taps: Dict[str, torch.Tensor] = {}
        for stage in range(self.n_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                h = block(h)
            taps[f"layer{stage + 1}"] = h.permute(0, 2, 3, 1)
        pooled = h.mean(dim=(2, 3))
        # flax's Dense in the compute type: the product, then the bias
        logits = (pooled.to(self.dtype) @ self.fc.weight.to(self.dtype).t()
                  + self.fc.bias.to(self.dtype))
        if return_layers:
            taps["pooled"] = pooled
            taps["logits"] = logits
            return taps
        return logits


def resnet50(dtype=torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), dtype=dtype)


def resnet101(dtype=torch.float32) -> ResNet:
    return ResNet((3, 4, 23, 3), dtype=dtype)


# ImageNet preprocessing constants (torchvision convention)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """uint8 or [0, 1] float (B, H, W, 3) -> ImageNet-normalized fp32 (a
    bf16 input is promoted, as the JAX package's fp32 constants do)."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def load_variables(model: ResNet, variables: Dict) -> ResNet:
    """Load the flax ResNet's {"params", "batch_stats"} (numpy leaves;
    also a converted torchvision state dict split by
    core/convert.split_variables) into `model`, strictly."""
    from xlxmert_tpu_torch.core.convert import flax_to_state_dict

    sd = {}
    for col in ("params", "batch_stats"):
        sd.update(flax_to_state_dict(variables.get(col, {})))
    model.load_state_dict(sd)
    return model


def random_init(model: ResNet, seed: int = 0) -> ResNet:
    """Random weights (numpy, from `seed`): normal conv kernels scaled by
    sqrt(2 / fan_in), identity BatchNorms, a small classifier."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sd = {}
    for k, t in model.state_dict().items():
        if t.dim() == 4:
            v = rng.standard_normal(t.shape) * np.sqrt(2.0 / t[0].numel())
        elif t.dim() == 2:
            v = rng.standard_normal(t.shape) * 0.01
        elif k.endswith(("var", "weight")):
            v = np.ones(t.shape)
        else:
            v = np.zeros(t.shape)
        sd[k] = torch.from_numpy(v.astype(np.float32))
    model.load_state_dict(sd)
    return model


def grid_features(model: ResNet, images: torch.Tensor,
                  grid_size: int = 8) -> torch.Tensor:
    """(B, grid, grid, 2048) features from the layer4 map: the map
    average-pooled to (grid, grid), center-cropped first to the largest
    multiple of the grid when it is not one (static shapes, as the JAX
    package: torch AdaptiveAvgPool's ragged windows differ), so the
    output grid is always (grid, grid)."""
    h = model(normalize_image(images), return_layers=True)["layer4"]
    B, H, W, C = h.shape
    if (H, W) != (grid_size, grid_size):
        if H < grid_size or W < grid_size:
            raise ValueError(
                f"layer4 map {H}x{W} is smaller than the {grid_size}x"
                f"{grid_size} grid — use --image_size >= {32 * grid_size}")
        kh, kw = H // grid_size, W // grid_size
        oh, ow = (H - kh * grid_size) // 2, (W - kw * grid_size) // 2
        h = h[:, oh:oh + kh * grid_size, ow:ow + kw * grid_size]
        h = F.avg_pool2d(h.permute(0, 3, 1, 2), (kh, kw)).permute(0, 2, 3, 1)
    return h
