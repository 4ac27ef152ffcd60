"""Plain fp32 render of the X-LXMERT SPADE generator
(image_generator/src/layers.py: SPADE :9-47, GeneratorResidualBlock
:65-113, ToRGB :116-132, Generator :135-260), inference mode.

The 8x8 code grid (B, 64, D) -> tanh(1x1 conv to the codebook width) ->
two grouped 3x3 spectral-normed convolutions (the learned start and the
style map y) -> log2(target / 8) residual blocks, each SPADE (instance
norm, no affine, times 1 + gamma plus beta, both predicted by 3x3
convolutions from y resized to the activation) -> leaky ReLU 0.2 -> 2x
bilinear upsampling -> spectral-normed 3x3 conv, twice, plus the 1x1
skip of the upsampled input; each block's 3x3 ToRGB resized to the
target and summed -> tanh -> images in [0, 1] as (B, S, S, 3).
Spectral norm divides a kernel by u^T W v with the stored u, v.
Bilinear resizes use half-pixel centres (align_corners False).

`fp8=True` is the control: every convolution's input and weight pass
through float8 e4m3 with a per-tensor scale before the fp32 product.
Weights are {torch name: fp32 tensor} (portbench/lib/weights.py
`generator_spec`). Imports torch only.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = torch.clamp_min(x.abs().amax() / E4M3_MAX, 1e-12)
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Render:
    def __init__(self, w: Dict[str, torch.Tensor], sizes: Dict,
                 fp8: bool = False):
        self.w, self.s, self.fp8 = w, sizes, fp8

    def conv(self, x, name, groups=1):
        k = self.w[f"{name}.weight"]
        if f"{name}.u" in self.w:
            u, v = self.w[f"{name}.u"], self.w[f"{name}.v"]
            k = k / (u @ (k.reshape(k.shape[0], -1) @ v))
        if self.fp8:
            x, k = _fp8(x), _fp8(k)
        y = F.conv2d(x, k, padding=k.shape[-1] // 2, groups=groups)
        return y + self.w[f"{name}.bias"][:, None, None]

    @staticmethod
    def resize(x, hw):
        if tuple(x.shape[2:]) == tuple(hw):
            return x
        return F.interpolate(x, size=hw, mode="bilinear",
                             align_corners=False)

    def spade(self, x, y, name):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        normalized = (x - mean) * torch.rsqrt(var + 1e-5)
        actv = F.relu(self.conv(self.resize(y, x.shape[2:]),
                                f"{name}.shared.0"))
        return normalized * (1 + self.conv(actv, f"{name}.gamma")) \
            + self.conv(actv, f"{name}.beta")

    def __call__(self, code: torch.Tensor) -> torch.Tensor:
        G, S = self.s["grid_size"], self.s["target_size"]
        B = code.shape[0]
        emb = code.float().reshape(B, G, G, -1).permute(0, 3, 1, 2)
        emb = torch.tanh(self.conv(emb, "bottleneck_emb.0"))
        h = self.conv(emb, "learned_init_conv.0", groups=4)
        y = self.conv(emb, "style_init_conv.0", groups=4)
        out = torch.zeros(B, 3, S, S, device=code.device)
        n = int(math.log2(S // G))
        for i in range(n):
            b = f"resblocks.{i}"
            hw = (h.shape[2] * 2, h.shape[3] * 2)
            t = F.leaky_relu(self.spade(h, y, f"{b}.cbn1"), 0.2)
            t = self.conv(self.resize(t, hw), f"{b}.conv1")
            t = F.leaky_relu(self.spade(t, y, f"{b}.cbn2"), 0.2)
            t = self.conv(t, f"{b}.conv2")
            h = t + self.conv(self.resize(h, hw), f"{b}.res_branch.1")
            rgb = self.conv(h, f"to_RGB_blocks.{i}.conv")
            out = out + (self.resize(rgb, (S, S)) if i + 1 < n else rgb)
        img = torch.tanh(out).permute(0, 2, 3, 1)
        return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)
