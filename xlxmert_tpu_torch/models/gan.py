"""SPADE generator, inference half (port of xlxmert_tpu/models/gan.py):
grid codes -> pixels.

Reference: image_generator/src/layers.py —
  - SPADE (:9-47): InstanceNorm (no affine) + conv-predicted gamma/beta
    from the code map, bilinear-resized to the activation size;
  - NoiseInjection (:50-62), GeneratorResidualBlock (:65-113),
    ToRGB (:116-132), Generator (:135-260): 2048-d code grid ->
    bottleneck tanh 1x1 conv to codebook_dim -> grouped 3x3 init convs ->
    log2(target/8) upscale resblocks with per-block ToRGB skip-sum -> tanh.

NCHW inside, `F.conv2d` for every convolution (the JAX package leaves
them to XLA, outside any Pallas kernel); the public `Generator.forward`
takes the JAX layout, (B, V, D) or (B, H, W, D) codes, and returns
(B, target, target, 3) in [-1, 1]. Modules keep the flax tree's names
(`bottleneck_emb_0` is `bottleneck_emb.0`, as the reference's torch
Sequential names it), so `load_variables` carries a flax checkpoint's
params, spectral-norm u/v and batch statistics across through
core/convert.flax_to_state_dict.

Numerics follow the reference: bilinear upsampling as two products with
interpolation matrices (half-pixel centres, torch align_corners=False);
spectral norm divides the kernel by sigma = u^T W v from the stored u, v
(no power iteration at inference); the convolution and then its bias in
the compute type; instance norm in fp32.

`mod_cap` is the JAX `render_mode(cap)`: SPADE computes its gamma/beta
convolutions at no more than mod_cap x mod_cap and upsamples the two
maps to the block's size (None, the default, is the exact render). The
modulation input is itself an upsampling of the 8x8 code map, so the
two maps are smooth. The H100's render times with and without the cap
are in PERF.md.

Not ported yet: the discriminator, the training losses, noise injection
in training and the TPU's phase-packed conv lowering (`conv_pack_mode`).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class _resolution_channels:
    """layers.py:161-175 — min(512, base) everywhere except the two
    largest resolutions (112/128 -> min(256,.), 224/256 -> min(128,.));
    generalized to any resolution by threshold."""

    def __init__(self, base_dim: int):
        self.base_dim = base_dim

    def __getitem__(self, res: int) -> int:
        if res >= 224:
            return min(128, self.base_dim)
        if res >= 112:
            return min(256, self.base_dim)
        return min(512, self.base_dim)


@functools.lru_cache(maxsize=None)
def _interp_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) bilinear interpolation matrix, half-pixel centres
    (torch align_corners=False)."""
    W = np.zeros((dst, src), np.float32)
    for t in range(dst):
        x = (t + 0.5) * src / dst - 0.5
        x0 = int(np.floor(x))
        w = x - x0
        W[t, min(max(x0, 0), src - 1)] += 1.0 - w
        W[t, min(max(x0 + 1, 0), src - 1)] += w
    return W


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear upsampling to `size`, half-pixel centres: two
    products with the interpolation matrices, in x's type. Downsampling
    (antialiased in the JAX package) is not used by the generator and
    raises."""
    H, W = x.shape[2], x.shape[3]
    if size[0] < H or size[1] < W:
        raise ValueError(f"resize_bilinear: {(H, W)} -> {tuple(size)} "
                         "downsamples; only upsampling is ported")
    wh = torch.from_numpy(_interp_matrix(size[0], H)).to(x.device, x.dtype)
    ww = torch.from_numpy(_interp_matrix(size[1], W)).to(x.device, x.dtype)
    return torch.matmul(torch.matmul(wh, x), ww.t())


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))


class SNConv(nn.Module):
    """Conv2d (SAME padding, stride 1) with optional spectral
    normalization: weight (out, in/groups, k, k), bias (out,), and with
    `use_sn` the buffers u (out,) and v (in/groups * k * k,). sigma is
    u^T (W v) over the (out, in*k*k) weight matrix, fp32, as torch's
    spectral_norm at eval (compute_weight without a power iteration)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_sn: bool = True, feature_group_count: int = 1,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        k, groups = kernel_size, feature_group_count
        self.padding, self.groups, self.dtype = k // 2, groups, dtype
        self.use_sn = use_sn
        self.weight = nn.Parameter(torch.empty(features,
                                               in_features // groups, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        if use_sn:
            self.register_buffer("u", torch.empty(features))
            self.register_buffer("v", torch.empty(in_features // groups
                                                  * k * k))

    def sigma(self) -> torch.Tensor:
        w = self.weight.float()
        return self.u @ (w.reshape(w.shape[0], -1) @ self.v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        if self.use_sn:
            w = w / self.sigma()
        y = F.conv2d(x.to(self.dtype), w.to(self.dtype),
                     padding=self.padding, groups=self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over NCHW's H, W per channel/sample."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class SPADE(nn.Module):
    """layers.py:9-47. y (the code map) is resized to x's size. norm_type
    "instance" (default) or "batch" (BatchNorm2d(affine=False) on the
    running statistics `mean`/`var`: the inference half)."""

    def __init__(self, x_dim: int, y_dim: int, nhidden: int = 128,
                 norm_type: str = "instance", dtype=torch.float32,
                 mod_cap: Optional[int] = None):
        super().__init__()
        self.norm_type, self.dtype, self.mod_cap = norm_type, dtype, mod_cap
        if norm_type == "batch":
            self.register_buffer("mean", torch.zeros(x_dim))
            self.register_buffer("var", torch.ones(x_dim))
        self.shared = nn.ModuleList([SNConv(y_dim, nhidden, 3, use_sn=False,
                                            dtype=dtype)])
        self.gamma = SNConv(nhidden, x_dim, 3, use_sn=False, dtype=dtype)
        self.beta = SNConv(nhidden, x_dim, 3, use_sn=False, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.norm_type == "batch":
            normalized = ((xf - self.mean[:, None, None])
                          * torch.rsqrt(self.var[:, None, None] + 1e-5))
        else:
            normalized = instance_norm(xf)
        normalized = normalized.to(self.dtype)
        H, W = x.shape[2], x.shape[3]
        cap = self.mod_cap
        mod_hw = (min(H, cap), min(W, cap)) if cap else (H, W)
        actv = F.relu(self.shared[0](resize_bilinear(y, mod_hw)))
        gamma, beta = self.gamma(actv), self.beta(actv)
        if mod_hw != (H, W):
            gamma = resize_bilinear(gamma, (H, W))
            beta = resize_bilinear(beta, (H, W))
        return normalized * (1 + gamma) + beta


class NoiseInjection(nn.Module):
    """layers.py:50-62: image + weight * N(0,1) in training, the identity
    at inference (the only half ported)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return image


class GeneratorResidualBlock(nn.Module):
    """layers.py:65-113: SPADE -> noise -> LReLU -> upsample -> SN-conv
    x2 + 1x1-conv skip."""

    def __init__(self, n_in: int, n_out: int, y_dim: int,
                 upscale: bool = True, use_sn: bool = True,
                 norm_type: str = "instance", dtype=torch.float32,
                 mod_cap: Optional[int] = None):
        super().__init__()
        self.upscale = upscale
        self.cbn1 = SPADE(n_in, y_dim, norm_type=norm_type, dtype=dtype,
                          mod_cap=mod_cap)
        self.noise1 = NoiseInjection()
        self.conv1 = SNConv(n_in, n_out, 3, use_sn, dtype=dtype)
        self.cbn2 = SPADE(n_out, y_dim, norm_type=norm_type, dtype=dtype,
                          mod_cap=mod_cap)
        self.noise2 = NoiseInjection()
        self.conv2 = SNConv(n_out, n_out, 3, use_sn, dtype=dtype)
        # the reference's res_branch Sequential holds the conv at index 1
        self.res_branch = nn.ModuleDict(
            {"1": SNConv(n_in, n_out, 1, use_sn, dtype=dtype)})

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.noise1(self.cbn1(x, y)), 0.2)
        if self.upscale:
            h = upsample2x(h)
        h = self.conv1(h)
        h = F.leaky_relu(self.noise2(self.cbn2(h, y)), 0.2)
        h = self.conv2(h)
        res = upsample2x(x) if self.upscale else x
        return h + self.res_branch["1"](res)


class ToRGB(nn.Module):
    """layers.py:116-132."""

    def __init__(self, n_in: int, target_size: int, dtype=torch.float32):
        super().__init__()
        self.target_size = target_size
        self.conv = SNConv(n_in, 3, 3, use_sn=False, dtype=dtype)

    def forward(self, x: torch.Tensor, up: bool = True) -> torch.Tensor:
        h = self.conv(x)
        if up:
            h = resize_bilinear(h, (self.target_size, self.target_size))
        return h


class Generator(nn.Module):
    """layers.py:135-260 at inference. forward(emb): the code grid (B,
    init_H, init_W, emb_dim) or (B, init_H*init_W, emb_dim) -> (B, target,
    target, 3) in [-1, 1], in the compute type `dtype`."""

    def __init__(self, emb_dim: int = 2048, base_dim: int = 32,
                 target_size: int = 256, extra_layers: int = 0,
                 init_H: int = 8, init_W: int = 8, use_sn: bool = True,
                 codebook_dim: int = 256, norm_type: str = "spade_in",
                 dtype=torch.float32, mod_cap: Optional[int] = None):
        super().__init__()
        self.init_H, self.init_W = init_H, init_W
        self.target_size, self.dtype = target_size, dtype
        chans = _resolution_channels(base_dim)
        self.bottleneck_emb = nn.ModuleList([SNConv(
            emb_dim, codebook_dim, 1, use_sn=False, dtype=dtype)])
        n_init = base_dim
        self.learned_init_conv = nn.ModuleList([SNConv(
            codebook_dim, n_init, 3, use_sn, feature_group_count=4,
            dtype=dtype)])
        self.style_init_conv = nn.ModuleList([SNConv(
            codebook_dim, n_init, 3, use_sn, feature_group_count=4,
            dtype=dtype)])
        n_up = int(math.log2(target_size // init_H))
        n_blocks = n_up + extra_layers
        norm = "batch" if "bn" in norm_type else "instance"
        blocks, rgbs, res, n_in = [], [], init_H, n_init
        for i in range(n_blocks):
            upscale = i < n_up
            if upscale:
                res *= 2
            blocks.append(GeneratorResidualBlock(
                n_in, chans[res], n_init, upscale=upscale, use_sn=use_sn,
                norm_type=norm, dtype=dtype, mod_cap=mod_cap))
            rgbs.append(ToRGB(chans[res], target_size, dtype=dtype))
            n_in = chans[res]
        self.resblocks = nn.ModuleList(blocks)
        self.to_RGB_blocks = nn.ModuleList(rgbs)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        if emb.dim() == 3:  # (B, V, D) -> (B, H, W, D)
            emb = emb.reshape(emb.shape[0], self.init_H, self.init_W, -1)
        emb = emb.to(self.dtype).permute(0, 3, 1, 2)
        emb = torch.tanh(self.bottleneck_emb[0](emb))
        h = self.learned_init_conv[0](emb)
        y = self.style_init_conv[0](emb)
        B, S = emb.shape[0], self.target_size
        out = torch.zeros(B, 3, S, S, dtype=self.dtype, device=emb.device)
        n_blocks = len(self.resblocks)
        for i, (block, rgb) in enumerate(zip(self.resblocks,
                                             self.to_RGB_blocks)):
            h = block(h, y)
            out = out + rgb(h, up=(i + 1) < n_blocks)
        return torch.tanh(out).permute(0, 2, 3, 1)


def load_variables(gen: Generator, params: Dict, sn: Optional[Dict] = None,
                   batch_stats: Optional[Dict] = None) -> Generator:
    """Load the flax Generator's variable collections (numpy leaves) into
    `gen`, strictly: "params" (conv kernels (kh, kw, in, out), biases,
    noise scales), "sn" (u, v per spectral-normed conv) and, for
    norm_type "spade_bn", "batch_stats" (mean, var)."""
    from xlxmert_tpu_torch.core.convert import flax_to_state_dict

    sd = {}
    for tree in (params, sn or {}, batch_stats or {}):
        sd.update(flax_to_state_dict(tree))
    gen.load_state_dict(sd)
    return gen


def render(gen: Generator, code: torch.Tensor) -> torch.Tensor:
    """Codes -> images in [0, 1], (B, target, target, 3), in the
    generator's compute type (the JAX CLI's renderer)."""
    with torch.inference_mode():
        return torch.clamp((gen(code) + 1.0) / 2.0, 0.0, 1.0)


def random_variables(emb_dim: int = 2048, base_dim: int = 32,
                     target_size: int = 256, init_H: int = 8,
                     codebook_dim: int = 256, seed: int = 0) -> Dict:
    """A random generator in the flax layout ({"params", "sn"}, numpy,
    from `seed`), as Generator(use_sn=True, norm_type "spade_in") reads
    it: normal kernels scaled by 1/sqrt(fan_in), small biases, and u, v
    from 50 power iterations of each spectral-normed kernel (a trained
    checkpoint's are converged), so every sigma is close to the kernel's
    largest singular value."""
    from xlxmert_tpu_torch.core.convert import _fold_indices, _insert

    rng = np.random.default_rng(seed)
    gen = Generator(emb_dim, base_dim, target_size, init_H=init_H,
                    init_W=init_H, codebook_dim=codebook_dim)
    params: Dict = {}
    sn: Dict = {}
    for name, m in gen.named_modules():
        path = _fold_indices(name)
        if isinstance(m, NoiseInjection):
            _insert(params, path + ("scale",), np.zeros(1, np.float32))
        if not isinstance(m, SNConv):
            continue
        out, cin, kh, kw = m.weight.shape
        w = (rng.standard_normal((kh, kw, cin, out), dtype=np.float32)
             / np.float32(math.sqrt(cin * kh * kw)))
        _insert(params, path + ("kernel",), w)
        if m.bias is not None:
            _insert(params, path + ("bias",),
                    rng.standard_normal(out, dtype=np.float32) * 0.02)
        if m.use_sn:
            mat = w.transpose(3, 2, 0, 1).reshape(out, -1)
            u = rng.standard_normal(out).astype(np.float32)
            for _ in range(50):
                v = mat.T @ u
                v /= np.linalg.norm(v) + 1e-12
                u = mat @ v
                u /= np.linalg.norm(u) + 1e-12
            _insert(sn, path + ("u",), u.astype(np.float32))
            _insert(sn, path + ("v",), v.astype(np.float32))
    return {"params": params, "sn": sn}
