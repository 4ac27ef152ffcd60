"""SPADE GAN (port of xlxmert_tpu/models/gan.py): grid codes -> pixels
generator and its discriminator, for inference and training.

Reference: image_generator/src/layers.py —
  - SPADE (:9-47): InstanceNorm (no affine) + conv-predicted gamma/beta
    from the code map, bilinear-resized to the activation size;
  - NoiseInjection (:50-62), GeneratorResidualBlock (:65-113),
    ToRGB (:116-132), Generator (:135-260): 2048-d code grid ->
    bottleneck tanh 1x1 conv to codebook_dim -> grouped 3x3 init convs ->
    log2(target/8) upscale resblocks with per-block ToRGB skip-sum -> tanh;
  - DiscriminatorResidualBlock (:352-393), Discriminator (:396-558):
    SN-resnet downsampling to 8x8, patch adv head, ACGAN per-cell
    10000-way classifier with centroid-tied weight (main.py:98-99) or a
    projection-discriminator head.

NCHW inside, `F.conv2d` for every convolution (the JAX package leaves
them to XLA, outside any Pallas kernel); the public forwards take and
return the JAX layout: `Generator.forward` takes (B, V, D) or (B, H, W,
D) codes and returns (B, target, target, 3) in [-1, 1];
`Discriminator.forward` takes (B, S, S, 3) images and returns its
feature maps (B, H, W, C). Modules keep the flax tree's names
(`bottleneck_emb_0` is `bottleneck_emb.0`, as the reference's torch
Sequential names it), so `load_variables` carries a flax checkpoint's
params, spectral-norm u/v and batch statistics across through
core/convert.flax_to_state_dict, and `variables_of` gives them back.

Numerics follow the JAX package: bilinear upsampling as two products
with interpolation matrices (half-pixel centres, torch
align_corners=False); the convolution and then its bias in the compute
type; instance and batch norm in fp32. Spectral norm divides the kernel
by sigma = u^T W v over the (out, in*k*k) weight matrix; with
`update_sn` one power iteration (torch's order: v = W^T u / |.|, then
u = W v / |.|, eps 1e-12, no gradient) first writes new u, v to the
buffers, and sigma keeps its gradient through W. Training mode
(`train=True`) normalizes the batch-norm SPADE by the batch's
statistics over (N, H, W) and updates the running ones (momentum 0.1,
unbiased variance), and adds noise, drawn from the `torch.Generator`
the caller passes, scaled by each NoiseInjection's learnt scale. The
ACGAN logits take compute-type operands with fp32 sums and an fp32
result, as the JAX einsum's preferred_element_type does
(`class_logits`).

`mod_cap` is the JAX `render_mode(cap)`: SPADE computes its gamma/beta
convolutions at no more than mod_cap x mod_cap and upsamples the two
maps to the block's size (None, the default, is the exact render). The
modulation input is itself an upsampling of the 8x8 code map, so the
two maps are smooth. The H100's render times with and without the cap
are in PERF.md.

Not ported: the TPU's phase-packed conv lowering (`conv_pack_mode`,
off by default in the JAX package).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xlxmert_tpu_torch.utils.profiling import span


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
    u^T (W v) over the (out, in*k*k) weight matrix, fp32; without
    `update_sn` the stored u, v are used as they are (torch's
    compute_weight without a power iteration)."""

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

    @torch.no_grad()
    def power_iteration(self) -> None:
        """One power iteration on the weight matrix, written to u, v."""
        w = self.weight.float()
        w = w.reshape(w.shape[0], -1)
        v = w.t() @ self.u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = w @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        self.u.copy_(u)
        self.v.copy_(v)

    def forward(self, x: torch.Tensor, update_sn: bool = False
                ) -> torch.Tensor:
        w = self.weight.float()
        if self.use_sn:
            if update_sn:
                self.power_iteration()
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
    "instance" (default) or "batch" (BatchNorm2d(affine=False): the
    batch's statistics in training, updating the running `mean`/`var`
    (momentum 0.1, unbiased variance); the running ones otherwise).
    With `sync_group` (`sync_batch_norm`) the training statistics are
    the global batch's: the sums, the counts and then the squared
    deviations are summed over the data group through a differentiable
    all-reduce (the reference's SyncBatchNorm, main.py:149-151; the JAX
    package's SPMD step), so the running statistics stay equal on every
    rank."""

    sync_group = None

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

    def _batch_norm(self, x: torch.Tensor, train: bool, eps: float = 1e-5,
                    momentum: float = 0.1) -> torch.Tensor:
        xf = x.float()
        if train and self.sync_group is not None:
            from xlxmert_tpu_torch.parallel.mesh import all_reduce_sum

            local = x.shape[0] * x.shape[2] * x.shape[3]
            sums = all_reduce_sum(torch.cat([
                xf.sum(dim=(0, 2, 3)),
                torch.full((1,), float(local), device=x.device)]),
                self.sync_group)
            n = sums[-1]
            mean = sums[:-1] / n
            d = xf - mean[:, None, None]
            var = all_reduce_sum((d * d).sum(dim=(0, 2, 3)),
                                 self.sync_group) / n
            with torch.no_grad():
                unbiased = var * (n / torch.clamp(n - 1, min=1))
                self.mean.copy_((1 - momentum) * self.mean + momentum * mean)
                self.var.copy_((1 - momentum) * self.var
                               + momentum * unbiased)
        elif train:
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
            n = x.shape[0] * x.shape[2] * x.shape[3]
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                self.mean.copy_((1 - momentum) * self.mean + momentum * mean)
                self.var.copy_((1 - momentum) * self.var
                               + momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        return (xf - mean[:, None, None]) * torch.rsqrt(
            var[:, None, None] + eps)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        if self.norm_type == "batch":
            normalized = self._batch_norm(x, train)
        else:
            normalized = instance_norm(x.float())
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
    """layers.py:50-62: image + weight * N(0,1) of shape (B, 1, H, W),
    drawn in the image's type from `noise` (a torch.Generator on the
    image's device) in training; the identity when `noise` is None."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, image: torch.Tensor,
                noise: Optional[torch.Generator] = None) -> torch.Tensor:
        if noise is None:
            return image
        B, _, H, W = image.shape
        n = torch.randn(B, 1, H, W, generator=noise, device=image.device,
                        dtype=image.dtype)
        return image + self.weight.to(image.dtype)[:, None, None] * n


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

    def forward(self, x: torch.Tensor, y: torch.Tensor, train: bool = False,
                update_sn: bool = False,
                noise: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.noise1(self.cbn1(x, y, train), noise)
        h = F.leaky_relu(h, 0.2)
        if self.upscale:
            h = upsample2x(h)
        h = self.conv1(h, update_sn)
        h = F.leaky_relu(self.noise2(self.cbn2(h, y, train), noise), 0.2)
        h = self.conv2(h, update_sn)
        res = upsample2x(x) if self.upscale else x
        return h + self.res_branch["1"](res, update_sn)


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
    """layers.py:135-260. forward(emb, train, update_sn, noise): the code
    grid (B, init_H, init_W, emb_dim) or (B, init_H*init_W, emb_dim) ->
    (B, target, target, 3) in [-1, 1], in the compute type `dtype`.
    Inference by default (the JAX module's train=False); `train=True`
    takes batch statistics and adds noise from `noise`, a
    torch.Generator, which it then needs; `update_sn` runs each
    spectral norm's power iteration."""

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

    def forward(self, emb: torch.Tensor, train: bool = False,
                update_sn: bool = False,
                noise: Optional[torch.Generator] = None) -> torch.Tensor:
        if train and noise is None:
            raise ValueError("Generator(train=True) adds noise: pass the "
                             "torch.Generator to draw it from (noise=)")
        noise = noise if train else None
        if emb.dim() == 3:  # (B, V, D) -> (B, H, W, D)
            emb = emb.reshape(emb.shape[0], self.init_H, self.init_W, -1)
        emb = emb.to(self.dtype).permute(0, 3, 1, 2)
        emb = torch.tanh(self.bottleneck_emb[0](emb))
        h = self.learned_init_conv[0](emb, update_sn)
        y = self.style_init_conv[0](emb, update_sn)
        B, S = emb.shape[0], self.target_size
        out = torch.zeros(B, 3, S, S, dtype=self.dtype, device=emb.device)
        n_blocks = len(self.resblocks)
        for i, (block, rgb) in enumerate(zip(self.resblocks,
                                             self.to_RGB_blocks)):
            h = block(h, y, train, update_sn, noise)
            out = out + rgb(h, up=(i + 1) < n_blocks)
        return torch.tanh(out).permute(0, 2, 3, 1)


class DiscriminatorResidualBlock(nn.Module):
    """layers.py:352-393: (LReLU) -> SN-conv -> instance norm -> LReLU ->
    SN-conv (-> 2x2 average pool) + 1x1 SN-conv skip."""

    def __init__(self, n_in: int, n_out: int, downsample: bool = True,
                 first_relu: bool = True, use_sn: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.downsample, self.first_relu, self.dtype = (downsample,
                                                        first_relu, dtype)
        self.conv1 = SNConv(n_in, n_out, 3, use_sn, dtype=dtype)
        self.conv2 = SNConv(n_out, n_out, 3, use_sn, dtype=dtype)
        self.res_branch = nn.ModuleDict(
            {"1": SNConv(n_in, n_out, 1, use_sn, dtype=dtype)})

    def forward(self, x: torch.Tensor, update_sn: bool = False
                ) -> torch.Tensor:
        h = F.leaky_relu(x, 0.2) if self.first_relu else x
        res_in = h
        h2 = self.conv1(h, update_sn)
        h2 = instance_norm(h2.float()).to(self.dtype)
        h2 = self.conv2(F.leaky_relu(h2, 0.2), update_sn)
        if self.downsample:
            h2 = F.avg_pool2d(h2, 2)
            res_in = F.avg_pool2d(res_in, 2)
        return h2 + self.res_branch["1"](res_in, update_sn)


class _ClassLogits(torch.autograd.Function):
    """(M, D) x (C, D)^T with fp32 sums and an fp32 result; the backward
    gives the first operand's gradient in its type (the centroids are a
    constant). Both directions run under the span
    "xlt.gan.acgan_product" (utils/profiling)."""

    @staticmethod
    def forward(ctx, a, c):
        ctx.save_for_backward(c)
        with span("xlt.gan.acgan_product"):
            if a.dtype == torch.float32:
                return torch.mm(a, c.t())
            if a.is_cuda:
                return torch.mm(a, c.t(), out_dtype=torch.float32)
            return torch.mm(a.float(), c.float().t())

    @staticmethod
    def backward(ctx, g):
        (c,) = ctx.saved_tensors
        with span("xlt.gan.acgan_product"):
            return torch.mm(g.to(c.dtype), c), None


def class_logits(emb: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The ACGAN head's product: (M, D) cell embeddings against the
    (C, D) centroid table in emb's type, fp32 logits (M, C): the JAX
    einsum with preferred_element_type=float32. bf16 operands go through
    cuBLAS's fp32-output GEMM on the card (torch.mm(out_dtype=)) and an
    fp32 product of the same values on the CPU."""
    return _ClassLogits.apply(emb, centroids.to(emb.dtype))


class Discriminator(nn.Module):
    """layers.py:396-558. forward(x, y=None, centroids=None, update_sn,
    cls_logits=True): images (B, S, S, 3) ->
      ACGAN: (adv (B,) fp32, D_layers, logits (B*H*W, n_classes) fp32),
        the classifier tied to `centroids` (C, emb_dim) given at call
        time (main.py:98-99), plus emb_classifier_bias; the class count
        comes from the table. With cls_logits=False the logits are
        skipped (None): a caller that drops them saves the product, as
        XLA drops them under jit;
      projection: (adv + proj (B,) fp32, D_layers), y the codes (B, V,
        emb_dim) or (B, H, W, emb_dim).
    D_layers are the residual blocks' outputs, (B, H, W, C) views."""

    def __init__(self, base_dim: int = 64, emb_dim: int = 2048,
                 target_size: int = 256, extra_layers: int = 0,
                 init_H: int = 8, init_W: int = 8, use_sn: bool = True,
                 acgan: bool = True, n_classes: int = 10000,
                 dtype=torch.float32):
        super().__init__()
        self.init_H, self.init_W = init_H, init_W
        self.acgan, self.dtype = acgan, dtype
        chans = _resolution_channels(base_dim)
        res = target_size
        n_down = int(math.log2(target_size // init_H))
        blocks, n_in = [], 3
        for i in range(extra_layers):
            blocks.append(DiscriminatorResidualBlock(
                n_in, chans[res], downsample=False, first_relu=(i != 0),
                use_sn=use_sn, dtype=dtype))
            n_in = chans[res]
        for i in range(n_down):
            res //= 2
            blocks.append(DiscriminatorResidualBlock(
                n_in, chans[res], downsample=True,
                first_relu=extra_layers > 0 or i > 0, use_sn=use_sn,
                dtype=dtype))
            n_in = chans[res]
        n_dim = chans[res]
        blocks.append(DiscriminatorResidualBlock(
            n_in, n_dim, downsample=False, first_relu=True, use_sn=use_sn,
            dtype=dtype))
        self.resblocks = nn.ModuleList(blocks)
        self.adv_out = SNConv(n_dim, 1, 3, use_sn, dtype=dtype)
        if acgan:
            self.emb_proj = SNConv(n_dim, emb_dim, 1, use_sn=False,
                                   dtype=dtype)
            self.emb_classifier_bias = nn.Parameter(torch.zeros(n_classes))
        else:
            self.y_proj = SNConv(emb_dim, n_dim // 2, 1, use_sn,
                                 use_bias=False, dtype=dtype)
            self.h_proj = SNConv(n_dim, n_dim // 2, 1, use_sn,
                                 use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                centroids: Optional[torch.Tensor] = None,
                update_sn: bool = False, cls_logits: bool = True):
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        D_layers = []
        for block in self.resblocks:
            h = block(h, update_sn)
            D_layers.append(h.permute(0, 2, 3, 1))
        h = F.relu(h)
        adv = self.adv_out(h, update_sn).mean(dim=(1, 2, 3))
        if self.acgan:
            n_classes = self.emb_classifier_bias.shape[0]
            if centroids is None or centroids.shape[0] != n_classes:
                raise ValueError(
                    f"the ACGAN head has {n_classes} classes: pass their "
                    "(n_classes, emb_dim) centroid table")
            logits = None
            if cls_logits:
                emb = self.emb_proj(h).permute(0, 2, 3, 1)
                logits = class_logits(emb.reshape(-1, emb.shape[-1]),
                                      centroids)
                logits = logits + self.emb_classifier_bias
            return adv.float(), D_layers, logits
        if y.dim() == 3:
            y = y.reshape(y.shape[0], self.init_H, self.init_W, -1)
        y_proj = self.y_proj(y.to(self.dtype).permute(0, 3, 1, 2),
                             update_sn)
        h_proj = self.h_proj(h, update_sn)
        proj = (h_proj * y_proj).sum(dim=1).mean(dim=(1, 2))
        return (adv + proj).float(), D_layers


def load_variables(module: nn.Module, params: Dict,
                   sn: Optional[Dict] = None,
                   batch_stats: Optional[Dict] = None) -> nn.Module:
    """Load a flax Generator's or Discriminator's variable collections
    (numpy leaves) into `module`, strictly: "params" (conv kernels (kh,
    kw, in, out), biases, noise scales, emb_classifier_bias), "sn" (u, v
    per spectral-normed conv) and, for norm_type "spade_bn",
    "batch_stats" (mean, var)."""
    from xlxmert_tpu_torch.core.convert import flax_to_state_dict

    sd = {}
    for tree in (params, sn or {}, batch_stats or {}):
        sd.update(flax_to_state_dict(tree))
    module.load_state_dict(sd)
    return module


def variables_of(module: nn.Module) -> Dict[str, Dict]:
    """`module`'s variables as the flax collections (numpy fp32 leaves),
    the inverse of `load_variables`: {"params", "sn", "batch_stats"}, the
    last only where the module holds batch statistics."""
    from xlxmert_tpu_torch.core.convert import convert_torch_state_dict

    buffers = dict(module.named_buffers())
    out = {"params": convert_torch_state_dict(dict(module.named_parameters())),
           "sn": convert_torch_state_dict(
               {k: t for k, t in buffers.items()
                if k.rsplit(".", 1)[-1] in ("u", "v")})}
    stats = {k: t for k, t in buffers.items()
             if k.rsplit(".", 1)[-1] in ("mean", "var")}
    if stats:
        out["batch_stats"] = convert_torch_state_dict(stats)
    return out


def render(gen: Generator, code: torch.Tensor) -> torch.Tensor:
    """Codes -> images in [0, 1], (B, target, target, 3), in the
    generator's compute type (the JAX CLI's renderer), under the span
    "xlt.render" (utils/profiling)."""
    with torch.inference_mode(), span("xlt.render"):
        return torch.clamp((gen(code) + 1.0) / 2.0, 0.0, 1.0)


def _orthogonal(rng: np.random.Generator, shape) -> np.ndarray:
    """flax's nn.initializers.orthogonal() for a (kh, kw, in, out) kernel:
    the (kh*kw*in, out) matrix's QR factor, signs fixed by R's
    diagonal."""
    n_cols = shape[-1]
    n_rows = int(np.prod(shape)) // n_cols
    a = rng.standard_normal((max(n_rows, n_cols), min(n_rows, n_cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape).astype(np.float32)


def _random_tree(module: nn.Module, seed: int, init: str) -> Dict:
    """Random variables of `module` in the flax layout ({"params", "sn"}
    [+ "batch_stats"], numpy, from `seed`). init "flax": the JAX modules'
    initializers (orthogonal kernels, zero biases and emb_classifier_bias,
    u, v ~ N(0, 1)); init "converged": normal kernels scaled by
    1/sqrt(fan_in), small biases, and u, v from 50 power iterations of
    each spectral-normed kernel (a trained checkpoint's are converged), so
    every sigma is close to the kernel's largest singular value. Noise
    scales are 0 and running statistics (0, 1) either way."""
    from xlxmert_tpu_torch.core.convert import _fold_indices, _insert

    rng = np.random.default_rng(seed)
    tree: Dict = {"params": {}, "sn": {}}
    for name, m in module.named_modules():
        path = _fold_indices(name) if name else ()
        if isinstance(m, NoiseInjection):
            _insert(tree["params"], path + ("scale",),
                    np.zeros(1, np.float32))
        if isinstance(m, Discriminator) and m.acgan:
            _insert(tree["params"], path + ("emb_classifier_bias",),
                    np.zeros(m.emb_classifier_bias.shape, np.float32))
        if isinstance(m, SPADE) and m.norm_type == "batch":
            stats = tree.setdefault("batch_stats", {})
            _insert(stats, path + ("mean",), np.zeros(m.mean.shape,
                                                      np.float32))
            _insert(stats, path + ("var",), np.ones(m.var.shape, np.float32))
        if not isinstance(m, SNConv):
            continue
        out, cin, kh, kw = m.weight.shape
        flax = init == "flax"
        if flax:
            w = _orthogonal(rng, (kh, kw, cin, out))
        else:
            w = (rng.standard_normal((kh, kw, cin, out), dtype=np.float32)
                 / np.float32(math.sqrt(cin * kh * kw)))
        _insert(tree["params"], path + ("kernel",), w)
        if m.bias is not None:
            _insert(tree["params"], path + ("bias",),
                    np.zeros(out, np.float32) if flax else
                    rng.standard_normal(out, dtype=np.float32) * 0.02)
        if m.use_sn:
            mat = w.transpose(3, 2, 0, 1).reshape(out, -1)
            u = rng.standard_normal(out).astype(np.float32)
            if flax:
                v = rng.standard_normal(mat.shape[1]).astype(np.float32)
            for _ in range(0 if flax else 50):
                v = mat.T @ u
                v /= np.linalg.norm(v) + 1e-12
                u = mat @ v
                u /= np.linalg.norm(u) + 1e-12
            _insert(tree["sn"], path + ("u",), u.astype(np.float32))
            _insert(tree["sn"], path + ("v",), v.astype(np.float32))
    return tree


def init_variables(module: nn.Module, seed: int) -> Dict:
    """Fresh training variables for a Generator or Discriminator, with the
    JAX modules' initializer distributions (the bits differ), in the flax
    layout."""
    return _random_tree(module, seed, "flax")


def random_variables(emb_dim: int = 2048, base_dim: int = 32,
                     target_size: int = 256, init_H: int = 8,
                     codebook_dim: int = 256, seed: int = 0) -> Dict:
    """A random generator in the flax layout ({"params", "sn"}, numpy,
    from `seed`), as Generator(use_sn=True, norm_type "spade_in") reads
    it, with converged spectral norms (`_random_tree`'s "converged")."""
    return _random_tree(Generator(emb_dim, base_dim, target_size,
                                  init_H=init_H, init_W=init_H,
                                  codebook_dim=codebook_dim),
                        seed, "converged")


def random_discriminator_variables(base_dim: int = 64, emb_dim: int = 2048,
                                   target_size: int = 256, init_H: int = 8,
                                   n_classes: int = 10000,
                                   acgan: bool = True, seed: int = 0
                                   ) -> Dict:
    """A random discriminator in the flax layout ({"params", "sn"}), as
    Discriminator(use_sn=True) of these sizes reads it, with converged
    spectral norms."""
    return _random_tree(Discriminator(base_dim, emb_dim, target_size,
                                      init_H=init_H, init_W=init_H,
                                      acgan=acgan, n_classes=n_classes),
                        seed, "converged")


def sync_batch_norm(model: nn.Module, group) -> nn.Module:
    """Take every batch-norm SPADE's training statistics over the data
    `group` (None: the rank's own batch)."""
    for m in model.modules():
        if isinstance(m, SPADE) and m.norm_type == "batch":
            m.sync_group = group
    return model
