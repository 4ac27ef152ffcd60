"""Detectron grid- and bbox-feature graph (port of
xlxmert_tpu/models/detectron.py): ResNeXt-FPN with FrozenBN, ROIAlign
and the MLP box head, plus the RPN and the class predictor of the bbox
path.

The network is the one the reference drives through maskrcnn-benchmark
(vilbert-multi-task's "detectron" model,
e2e_faster_rcnn_X-152-32x8d-FPN_1x_MLP_2048_FPN_512): the grid path
(coco_extract_grid_feature.py:41-53, 250-254) pools fixed grid boxes
from the FPN and keeps fc6, the 2,048-d features every released
X-LXMERT checkpoint was trained on.

Layout and numerics, as the JAX package: the public forwards take NHWC
images; inside, channels-last strides for activations and conv weights
(faster on the card than NCHW in bf16 and fp32) and `F.conv2d` for
every convolution, the grouped 3x3 as one
`groups=num_groups` call; FrozenBN folds to a scale and a bias in fp32,
cast to the compute type; a conv's bias and a Linear's are added after
the product, in the compute type. ROIAlign has `aligned=False`
semantics (no half-pixel offset, the roi size clamped to >= 1,
out-of-image samples counted as 0) and pools each roi only from its own
FPN level, the same numbers as the JAX package's masked sum over the
four levels. Ties of the top-k go to the lower index (a stable sort), as
jax.lax.top_k.

Module names are maskrcnn-benchmark's (`backbone.body.stem.conv1`,
`backbone.body.layer1.0.conv2`, `backbone.fpn.fpn_inner1`,
`roi_heads.box.feature_extractor.fc6`, `rpn.head.conv`,
`roi_heads.box.predictor.cls_score`), so a released detectron_model.pth
loads with `load_detectron_state_dict`; `load_params` takes the JAX
package's param tree. Everything here is plain PyTorch; no kernel of the
port is on this path.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xlxmert_tpu_torch.ops.box_selection import top_k_lower_index

# Detectron pixel means, BGR order (coco_extract_grid_feature.py:85)
PIXEL_MEANS_BGR = (102.9801, 115.9465, 122.7717)
MIN_SIZE = 800
MAX_SIZE = 1333


@dataclasses.dataclass(frozen=True)
class DetectronConfig:
    """X-152-32x8d-FPN_1x_MLP_2048_FPN_512 defaults."""

    stage_blocks: Tuple[int, ...] = (3, 8, 36, 3)
    num_groups: int = 32
    width_per_group: int = 8
    stem_channels: int = 64
    stage_out_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    fpn_dim: int = 512
    mlp_dim: int = 2048
    pooler_resolution: int = 7
    sampling_ratio: int = 2
    canonical_scale: int = 224
    canonical_level: int = 4
    stride_in_1x1: bool = True  # Detectron caffe2-style ResNeXt

    def bottleneck_channels(self, stage: int) -> int:
        return self.num_groups * self.width_per_group * (2 ** stage)


def tiny_detectron_config(**kw) -> DetectronConfig:
    """Small config for tests."""
    base = dict(stage_blocks=(1, 1, 1, 1), num_groups=2, width_per_group=4,
                stem_channels=8, stage_out_channels=(16, 32, 64, 128),
                fpn_dim=16, mlp_dim=24)
    base.update(kw)
    return DetectronConfig(**base)


class FrozenBN(nn.Module):
    """maskrcnn-benchmark FrozenBatchNorm2d (eps 0): the statistics
    folded to scale = weight * rsqrt(var) and bias - mean * scale in
    fp32, cast to the compute type, then x * scale + bias in one pass
    (`addcmul`, in place: the input is a fresh conv output), rounded
    once, as XLA's fusion of the JAX package's two ops rounds it."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((features,), fill))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var)
        scale = (self.weight * inv).to(self.dtype)
        bias = (self.bias - self.running_mean * self.weight * inv).to(
            self.dtype)
        return torch.addcmul(bias[:, None, None], x, scale[:, None, None],
                             out=x)


class Conv(nn.Module):
    """A conv with an OIHW weight (+ an optional bias, added after the
    product), in the compute type. Its parameters are frozen (the
    extraction graph is inference only), which keeps FrozenBN's in-place
    `addcmul` on the conv's output legal with autograd on."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 use_bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(
            features, in_features // groups, kernel_size, kernel_size),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(features), requires_grad=False)
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                     stride=self.stride, padding=self.padding,
                     groups=self.groups)
        if self.bias is not None:
            y = y.add_(self.bias.to(self.dtype)[:, None, None])
        return y


def _dense(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """flax nn.Dense in `dtype`: the product, then the bias add."""
    return (torch.matmul(x.to(dtype), lin.weight.to(dtype).t())
            + lin.bias.to(dtype))


class Bottleneck(nn.Module):
    """ResNeXt bottleneck with FrozenBN; the stride on the 1x1 when
    stride_in_1x1 (Detectron's caffe2 convention)."""

    def __init__(self, in_features: int, bottleneck: int, out_channels: int,
                 stride: int = 1, num_groups: int = 1,
                 stride_in_1x1: bool = True, dtype=torch.float32):
        super().__init__()
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv(in_features, bottleneck, 1, s1, dtype=dtype)
        self.bn1 = FrozenBN(bottleneck, dtype)
        self.conv2 = Conv(bottleneck, bottleneck, 3, s2, 1,
                          groups=num_groups, dtype=dtype)
        self.bn2 = FrozenBN(bottleneck, dtype)
        self.conv3 = Conv(bottleneck, out_channels, 1, dtype=dtype)
        self.bn3 = FrozenBN(out_channels, dtype)
        self.downsample = None
        if stride != 1 or in_features != out_channels:
            self.downsample = nn.ModuleList([
                Conv(in_features, out_channels, 1, stride, dtype=dtype),
                FrozenBN(out_channels, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.conv1(x)).relu_()
        h = self.bn2(self.conv2(h)).relu_()
        h = self.bn3(self.conv3(h))
        res = x
        if self.downsample is not None:
            res = self.downsample[1](self.downsample[0](x))
        return h.add_(res).relu_()


class _Stem(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.conv1 = Conv(3, channels, 7, 2, 3, dtype=dtype)
        self.bn1 = FrozenBN(channels, dtype)

    def forward(self, x):
        h = self.bn1(self.conv1(x)).relu_()
        return F.max_pool2d(h, 3, 2, padding=1)   # -inf padding, as flax


class ResNetBody(nn.Module):
    """Stem + 4 stages; returns [C2, C3, C4, C5] (strides 4/8/16/32)."""

    def __init__(self, cfg: DetectronConfig, dtype=torch.float32):
        super().__init__()
        self.stem = _Stem(cfg.stem_channels, dtype)
        n_in = cfg.stem_channels
        for s, n_blocks in enumerate(cfg.stage_blocks):
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(
                    n_in, cfg.bottleneck_channels(s),
                    cfg.stage_out_channels[s],
                    stride=2 if (b == 0 and s > 0) else 1,
                    num_groups=cfg.num_groups,
                    stride_in_1x1=cfg.stride_in_1x1, dtype=dtype))
                n_in = cfg.stage_out_channels[s]
            setattr(self, f"layer{s + 1}", nn.ModuleList(blocks))
        self.n_stages = len(cfg.stage_blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.stem(x)
        outs = []
        for s in range(self.n_stages):
            for block in getattr(self, f"layer{s + 1}"):
                h = block(h)
            outs.append(h)
        return outs


class FPN(nn.Module):
    """maskrcnn-benchmark FPN: 1x1 inner convs, the top-down nearest-2x
    sum, 3x3 output convs; LastLevelMaxPool adds P6. Returns [P2..P6]."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        for i, c in enumerate(in_channels):
            setattr(self, f"fpn_inner{i + 1}",
                    Conv(c, out_channels, 1, use_bias=True, dtype=dtype))
            setattr(self, f"fpn_layer{i + 1}",
                    Conv(out_channels, out_channels, 3, padding=1,
                         use_bias=True, dtype=dtype))
        self.n = len(in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        inners = [getattr(self, f"fpn_inner{i + 1}")(f)
                  for i, f in enumerate(feats)]
        laterals = [inners[-1]]
        for inner in reversed(inners[:-1]):
            up = F.interpolate(laterals[-1], scale_factor=2, mode="nearest")
            laterals.append(inner.add_(up))
        laterals = laterals[::-1]  # P2..P5
        outs = [getattr(self, f"fpn_layer{i + 1}")(lat)
                for i, lat in enumerate(laterals)]
        # LastLevelMaxPool: P6 = max_pool(P5, 1, stride 2)
        outs.append(F.max_pool2d(outs[-1], 1, 2))
        return outs


class DetectronBackbone(nn.Module):
    """body + FPN, the reference graph's `model.backbone(x)`. Takes NHWC
    images; returns [P2..P6], (B, C, H, W) tensors with channels-last
    strides."""

    def __init__(self, cfg: DetectronConfig, dtype=torch.float32):
        super().__init__()
        self.body = ResNetBody(cfg, dtype)
        self.fpn = FPN(cfg.stage_out_channels, cfg.fpn_dim, dtype)
        self.to(memory_format=torch.channels_last)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        # an NHWC batch seen as NCHW has channels-last strides already
        return self.fpn(self.body(images.permute(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# ROIAlign and the box head
# ---------------------------------------------------------------------------

def _bilinear_pool(flat: torch.Tensor, base, H, W, scale, rois,
                   resolution: int, sampling_ratio: int) -> torch.Tensor:
    """ROIAlign (aligned=False) of R rois from row-major (h, w, C) maps
    concatenated into `flat` (N, C): roi r reads the map that starts at
    row base[r], of H[r] x W[r], at spatial scale scale[r] (int64 and
    fp32 (R,) tensors). Returns (R, res, res, C) fp32 (the JAX package's
    promotion: fp32 weights times the map's values)."""
    res, n = resolution, sampling_ratio
    dev = rois.device
    s = scale[:, None]
    x0, y0, x1, y1 = (rois[:, i:i + 1] * s for i in range(4))
    rw = torch.clamp(x1 - x0, min=1.0)
    rh = torch.clamp(y1 - y0, min=1.0)
    bw = rw / torch.full((), float(res), device=dev)
    bh = rh / torch.full((), float(res), device=dev)
    offs = (torch.arange(res, device=dev, dtype=torch.float32)[:, None]
            + (torch.arange(n, device=dev, dtype=torch.float32)[None, :]
               + 0.5) / torch.full((), float(n), device=dev)).reshape(-1)
    ys = y0 + offs[None, :] * bh                  # (R, S)
    xs = x0 + offs[None, :] * bw
    Hc, Wc = H[:, None], W[:, None]

    def axis(v, size):
        valid = (v > -1.0) & (v < size.float())
        v = torch.clamp(v, min=0.0)
        lo = torch.minimum(torch.floor(v).long(), size - 1)
        hi = torch.minimum(lo + 1, size - 1)
        v = torch.where(lo >= size - 1, lo.float(), v)
        return valid, lo, hi, v - lo

    valid_y, yl, yh, ly = axis(ys, Hc)
    valid_x, xl, xh, lx = axis(xs, Wc)
    ly, lx = ly[:, :, None, None], lx[:, None, :, None]
    hy, hx = 1.0 - ly, 1.0 - lx
    row = base[:, None, None]
    Wr = W[:, None, None]

    def gather(yi, xi):
        idx = row + yi[:, :, None] * Wr + xi[:, None, :]   # (R, S, S)
        return flat[idx.reshape(-1)].reshape(*idx.shape, flat.shape[1])

    v = hy * hx * gather(yl, xl)
    v = v + hy * lx * gather(yl, xh)
    v = v + ly * hx * gather(yh, xl)
    v = v + ly * lx * gather(yh, xh)
    mask = (valid_y[:, :, None] & valid_x[:, None, :])[..., None]
    v = torch.where(mask, v, torch.zeros((), device=dev))
    R, C = v.shape[0], v.shape[-1]
    return v.reshape(R, res, n, res, n, C).mean(dim=(2, 4))


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              resolution: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign on one image, aligned=False. feat (H, W, C); rois (R, 4)
    xyxy in input-image coordinates. Returns (R, res, res, C)."""
    H, W, C = feat.shape
    R, dev = rois.shape[0], rois.device
    full = functools.partial(torch.full, (R,), device=dev)
    return _bilinear_pool(
        feat.reshape(H * W, C), full(0, dtype=torch.long),
        full(H, dtype=torch.long), full(W, dtype=torch.long),
        full(spatial_scale, dtype=torch.float32), rois.float(), resolution,
        sampling_ratio)


def fpn_level_assignment(rois: torch.Tensor, canonical_scale: int = 224,
                         canonical_level: int = 4, k_min: int = 2,
                         k_max: int = 5) -> torch.Tensor:
    """maskrcnn-benchmark LevelMapper: floor(lvl0 + log2(sqrt(area)/s0 +
    1e-6)) clamped to [k_min, k_max], as a 0-based int32 index."""
    x0, y0, x1, y1 = rois.unbind(-1)
    area = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    s = torch.sqrt(area)
    s0 = torch.full((), float(canonical_scale), device=rois.device)
    lvl = torch.floor(canonical_level + torch.log2(s / s0 + 1e-6))
    lvl = torch.clamp(lvl, k_min, k_max)
    return (lvl - k_min).int()


def pool_levels(levels: Sequence[torch.Tensor], rois: torch.Tensor,
                resolution: int = 7, sampling_ratio: int = 2,
                canonical_scale: int = 224, canonical_level: int = 4
                ) -> torch.Tensor:
    """Each roi pooled from its assigned FPN level (P2..P5, scales
    1/4..1/32), for a batch: levels[l] (B, C, H_l, W_l); rois (B, R, 4).
    Returns (B * R, res, res, C). One gather over the four levels'
    maps, concatenated channels-last."""
    B, R = rois.shape[:2]
    dev = rois.device
    flats, starts, hs, ws = [], [], [], []
    start = 0
    for feat in levels[:4]:
        _, C, h, w = feat.shape
        flats.append(feat.permute(0, 2, 3, 1).reshape(B * h * w, C))
        starts.append(start)
        hs.append(h)
        ws.append(w)
        start += B * h * w
    lvl = fpn_level_assignment(rois.reshape(B * R, 4), canonical_scale,
                               canonical_level).long()
    table = functools.partial(torch.tensor, device=dev)
    H, W = table(hs)[lvl], table(ws)[lvl]
    image = torch.arange(B, device=dev).repeat_interleave(R)
    base = table(starts)[lvl] + image * H * W
    scale = table([1.0 / 2 ** (l + 2) for l in range(len(flats))],
                  dtype=torch.float32)[lvl]
    return _bilinear_pool(torch.cat(flats), base, H, W, scale,
                          rois.reshape(B * R, 4).float(), resolution,
                          sampling_ratio)


def multilevel_roi_align(fpn_feats: Sequence[torch.Tensor],
                         rois: torch.Tensor, resolution: int = 7,
                         sampling_ratio: int = 2,
                         canonical_scale: int = 224,
                         canonical_level: int = 4) -> torch.Tensor:
    """One image, the JAX signature: fpn_feats[l] (H_l, W_l, C); rois
    (R, 4). Returns (R, res, res, C)."""
    return pool_levels([f.permute(2, 0, 1)[None] for f in fpn_feats[:4]],
                       rois[None], resolution, sampling_ratio,
                       canonical_scale, canonical_level)


class BoxHeadMLP(nn.Module):
    """FPN2MLPFeatureExtractor: flatten (NCHW order, the checkpoint's
    fc6) -> fc6 -> ReLU -> fc7 -> ReLU. Returns {'fc6', 'fc7'} of
    (R, mlp_dim)."""

    def __init__(self, in_features: int, mlp_dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc6 = nn.Linear(in_features, mlp_dim)
        self.fc7 = nn.Linear(mlp_dim, mlp_dim)

    def forward(self, pooled: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)
        fc6 = torch.relu(_dense(x, self.fc6, self.dtype))
        fc7 = torch.relu(_dense(fc6, self.fc7, self.dtype))
        return {"fc6": fc6, "fc7": fc7}


def grid_boxes(height, width, grid_size: int) -> torch.Tensor:
    """Fixed grid boxes over the valid (h, w) region
    (coco_extract_grid_feature.py:56-70): integer cell sizes h//g, w//g.
    height and width: numbers or tensors of any shape (...); returns
    (..., g*g, 4) fp32."""
    h, w = torch.as_tensor(height), torch.as_tensor(width)
    gh = torch.div(h, grid_size, rounding_mode="floor").float()[..., None]
    gw = torch.div(w, grid_size, rounding_mode="floor").float()[..., None]
    k = torch.arange(grid_size, dtype=torch.float32, device=h.device)
    ii = k.repeat_interleave(grid_size)
    jj = k.repeat(grid_size)
    return torch.stack([jj * gw, ii * gh, (jj + 1) * gw, (ii + 1) * gh],
                       dim=-1)


def _box_head(cfg: DetectronConfig, dtype) -> nn.ModuleDict:
    return nn.ModuleDict({"feature_extractor": BoxHeadMLP(
        cfg.fpn_dim * cfg.pooler_resolution ** 2, cfg.mlp_dim, dtype)})


class DetectronGridExtractor(nn.Module):
    """The grid graph, batched: a padded NHWC image batch and each
    image's valid (h, w) -> (B, grid*grid, mlp_dim) fc6 features
    (coco_extract_grid_feature.py:236-260 per image)."""

    def __init__(self, cfg: DetectronConfig, grid_size: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.cfg, self.grid_size, self.dtype = cfg, grid_size, dtype
        self.backbone = DetectronBackbone(cfg, dtype)
        self.roi_heads = nn.ModuleDict({"box": _box_head(cfg, dtype)})

    def forward(self, images: torch.Tensor, sizes: torch.Tensor
                ) -> torch.Tensor:
        """images: (B, H, W, 3) preprocessed (BGR - mean), zero-padded;
        sizes: (B, 2) int valid (h, w) per image."""
        cfg = self.cfg
        fpn = self.backbone(images)
        rois = grid_boxes(sizes[:, 0], sizes[:, 1], self.grid_size)
        pooled = pool_levels(fpn[:4], rois, cfg.pooler_resolution,
                             cfg.sampling_ratio, cfg.canonical_scale,
                             cfg.canonical_level)
        feats = self.roi_heads["box"]["feature_extractor"](pooled)["fc6"]
        return feats.reshape(images.shape[0], rois.shape[1], -1)


# ---------------------------------------------------------------------------
# RPN and the full detector (the bbox-feature path)
# ---------------------------------------------------------------------------

ANCHOR_SIZES = (32, 64, 128, 256, 512)  # one per FPN level P2..P6
ANCHOR_STRIDES = (4, 8, 16, 32, 64)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
BBOX_XFORM_CLIP = float(np.log(1000.0 / 16.0))


def _generate_cell_anchors(stride: int, size: int,
                           ratios=ASPECT_RATIOS) -> np.ndarray:
    """Caffe2-style generate_anchors: base [0,0,stride-1,stride-1],
    ratio enumeration with rounding, then scale enumeration."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)

    def whctr(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mkanchors(ws, hs, xc, yc):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                          xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)])

    w, h, xc, yc = whctr(base)
    size_ratios = (w * h) / np.asarray(ratios, np.float32)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.asarray(ratios, np.float32))
    ratio_anchors = mkanchors(ws, hs, xc, yc)

    scale = size / stride
    out = []
    for a in ratio_anchors:
        w, h, xc, yc = whctr(a)
        out.append(mkanchors(np.array([w * scale]), np.array([h * scale]),
                             xc, yc)[0])
    return np.asarray(out, np.float32)  # (A, 4)


def level_anchors(stride: int, size: int, fh: int, fw: int) -> np.ndarray:
    """All anchors of an (fh, fw) map: (fh*fw*A, 4), ordered (fh, fw, A),
    the head's (A*4) channel layout after the permute."""
    cell = _generate_cell_anchors(stride, size)  # (A, 4)
    sx = np.arange(fw, dtype=np.float32) * stride
    sy = np.arange(fh, dtype=np.float32) * stride
    shifts = np.stack(np.meshgrid(sx, sy, indexing="xy"), axis=-1)
    shifts = np.concatenate([shifts, shifts], axis=-1)  # (fh, fw, 4)
    anchors = shifts[:, :, None, :] + cell[None, None]  # (fh, fw, A, 4)
    return anchors.reshape(-1, 4)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """maskrcnn-benchmark BoxCoder.decode (the TO_REMOVE=1 era) over
    (..., 4): xyxy with the -1 end convention."""
    wx, wy, ww, wh = weights
    widths = anchors[..., 2] - anchors[..., 0] + 1.0
    heights = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * widths
    cy = anchors[..., 1] + 0.5 * heights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)
    pcx = dx * widths + cx
    pcy = dy * heights + cy
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw - 1, pcy + 0.5 * ph - 1], dim=-1)


def clip_boxes(boxes: torch.Tensor, h, w) -> torch.Tensor:
    """Clip (..., 4) boxes to [0, w-1] x [0, h-1]; h and w numbers or
    tensors that broadcast against boxes[..., 0]."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    hi_x = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device) - 1
    hi_y = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device) - 1
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([
        torch.minimum(torch.maximum(x0, zero), hi_x),
        torch.minimum(torch.maximum(y0, zero), hi_y),
        torch.minimum(torch.maximum(x1, zero), hi_x),
        torch.minimum(torch.maximum(y1, zero), hi_y)], dim=-1)


class RPNHead(nn.Module):
    """rpn.head: a shared 3x3 conv, then 1x1 objectness and 1x1 box
    deltas, applied to every FPN level."""

    def __init__(self, channels: int, num_anchors: int = len(ASPECT_RATIOS),
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, use_bias=True,
                         dtype=dtype)
        self.cls_logits = Conv(channels, num_anchors, 1, use_bias=True,
                               dtype=dtype)
        self.bbox_pred = Conv(channels, num_anchors * 4, 1, use_bias=True,
                              dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for f in feats:
            t = self.conv(f).relu_()
            logits.append(self.cls_logits(t))
            deltas.append(self.bbox_pred(t))
        return logits, deltas


class DetectronDetector(nn.Module):
    """The full bbox-feature graph (coco_extract_bbox_feature.py:131-156):
    backbone FPN -> RPN proposals -> box-head fc6/fc7 and class scores,
    in three stages that `forward` chains: `rpn_outputs`, `propose` and
    `box_head`.

    A static number of proposals per image (fpn_post_nms_top_n; invalid
    slots have score -inf): forward returns proposals (B, P, 4) in input
    coordinates, cls_scores (B, P, n_classes) before the softmax, the
    pooled features {'fc6', 'fc7'} of (B, P, mlp_dim) and the proposals'
    objectness logits (B, P)."""

    def __init__(self, cfg: DetectronConfig, n_classes: int = 1601,
                 pre_nms_top_n: int = 1000, post_nms_top_n: int = 1000,
                 fpn_post_nms_top_n: int = 1000, nms_thresh: float = 0.7,
                 dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.pre_nms_top_n = pre_nms_top_n
        self.post_nms_top_n = post_nms_top_n
        self.fpn_post_nms_top_n = fpn_post_nms_top_n
        self.nms_thresh = nms_thresh
        self.backbone = DetectronBackbone(cfg, dtype)
        self.rpn = nn.ModuleDict({"head": RPNHead(cfg.fpn_dim, dtype=dtype)})
        box = _box_head(cfg, dtype)
        box["predictor"] = nn.ModuleDict(
            {"cls_score": nn.Linear(cfg.mlp_dim, n_classes)})
        self.roi_heads = nn.ModuleDict({"box": box})
        self._anchors: Dict[Tuple, torch.Tensor] = {}

    def rpn_outputs(self, images: torch.Tensor):
        """(fpn [P2..P6], objectness logits per level (B, A, h, w), box
        deltas per level (B, 4A, h, w))."""
        fpn = self.backbone(images)
        logits, deltas = self.rpn["head"](fpn)
        return fpn, logits, deltas

    def anchors(self, lvl: int, fh: int, fw: int, device) -> torch.Tensor:
        key = (lvl, fh, fw, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(level_anchors(
                ANCHOR_STRIDES[lvl], ANCHOR_SIZES[lvl], fh, fw)).to(device)
        return self._anchors[key]

    def propose(self, logits: Sequence[torch.Tensor],
                deltas: Sequence[torch.Tensor], sizes: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """Per level: the pre-NMS top-k by objectness, decode, clip, NMS
        at nms_thresh (every level and image in one batched NMS, the
        levels padded to the largest k: the padding is never live, so
        each level's rounds are its own); then the overall top-P by
        objectness. Returns boxes (B, P, 4), scores (B, P) (the logits,
        -inf in invalid slots) and ids (B, P), each proposal's anchor as
        an index into the levels' concatenated anchors."""
        from xlxmert_tpu_torch.ops.nms import NEG, nms

        B = logits[0].shape[0]
        dev = logits[0].device
        hw = sizes.to(dev)
        per, offset = [], 0
        for lvl, (lg, dl) in enumerate(zip(logits, deltas)):
            fh, fw = lg.shape[2], lg.shape[3]
            n = lg.shape[1] * fh * fw
            lg = lg.permute(0, 2, 3, 1).reshape(B, n)
            dl = dl.permute(0, 2, 3, 1).reshape(B, n, 4)
            k = min(self.pre_nms_top_n, n)
            score, idx = top_k_lower_index(lg, k)
            anchors = self.anchors(lvl, fh, fw, dev)
            boxes = decode_boxes(anchors[idx], dl.gather(
                1, idx[..., None].expand(-1, -1, 4)))
            boxes = clip_boxes(boxes, hw[:, :1].to(boxes.dtype),
                               hw[:, 1:].to(boxes.dtype))
            per.append((score, idx, boxes, min(self.post_nms_top_n, k),
                        offset))
            offset += n
        K = max(p[0].shape[1] for p in per)
        pad = [K - p[0].shape[1] for p in per]
        stacked_boxes = torch.stack([F.pad(p[2].float(), (0, 0, 0, q))
                                     for p, q in zip(per, pad)])
        stacked_scores = torch.stack([
            F.pad(torch.sigmoid(p[0]).float(), (0, q), value=NEG)
            for p, q in zip(per, pad)])
        keep, valid = nms(stacked_boxes, stacked_scores, self.nms_thresh,
                          max(p[3] for p in per))      # (L, B, max_out)
        out_boxes, out_scores, out_ids = [], [], []
        for lvl, (score, idx, boxes, m, off) in enumerate(per):
            ki, v = keep[lvl, :, :m], valid[lvl, :, :m]
            out_boxes.append(boxes.gather(1, ki[..., None].expand(-1, -1, 4)))
            out_scores.append(torch.where(
                v, score.gather(1, ki),
                torch.full((), -math.inf, dtype=score.dtype, device=dev)))
            out_ids.append(idx.gather(1, ki) + off)
        boxes = torch.cat(out_boxes, dim=1)
        scores = torch.cat(out_scores, dim=1)
        ids = torch.cat(out_ids, dim=1)
        P = min(self.fpn_post_nms_top_n, scores.shape[1])
        top_scores, top = top_k_lower_index(scores, P)
        return {"boxes": boxes.gather(1, top[..., None].expand(-1, -1, 4)),
                "scores": top_scores, "ids": ids.gather(1, top)}

    def box_head(self, fpn: Sequence[torch.Tensor], proposals: torch.Tensor):
        """(cls_scores (B, P, n_classes), {'fc6', 'fc7'} (B, P, mlp))."""
        cfg = self.cfg
        B, P = proposals.shape[:2]
        pooled = pool_levels(fpn[:4], proposals, cfg.pooler_resolution,
                             cfg.sampling_ratio, cfg.canonical_scale,
                             cfg.canonical_level)
        box = self.roi_heads["box"]
        feats = box["feature_extractor"](pooled)
        feats = {k: v.reshape(B, P, -1) for k, v in feats.items()}
        cls = _dense(feats["fc7"], box["predictor"]["cls_score"], self.dtype)
        return cls, feats

    def forward(self, images: torch.Tensor, sizes: torch.Tensor):
        fpn, logits, deltas = self.rpn_outputs(images)
        prop = self.propose(logits, deltas, sizes)
        cls_scores, feats = self.box_head(fpn, prop["boxes"])
        return prop["boxes"], cls_scores, feats, prop["scores"]


# ---------------------------------------------------------------------------
# weights: the JAX package's param tree, a maskrcnn-benchmark state dict
# ---------------------------------------------------------------------------

def _tree_names(cfg: DetectronConfig) -> Dict[Tuple[str, ...], str]:
    """JAX param-tree module path -> maskrcnn-benchmark module name (the
    inverse of xlxmert_tpu/models/detectron.convert_detectron_state_dict)."""
    names = {("backbone", "body", "stem_conv1"): "backbone.body.stem.conv1",
             ("backbone", "body", "stem_bn1"): "backbone.body.stem.bn1"}
    for s, n_blocks in enumerate(cfg.stage_blocks):
        for b in range(n_blocks):
            jp = ("backbone", "body", f"layer{s + 1}_{b}")
            tp = f"backbone.body.layer{s + 1}.{b}"
            for c in (1, 2, 3):
                names[jp + (f"conv{c}",)] = f"{tp}.conv{c}"
                names[jp + (f"bn{c}",)] = f"{tp}.bn{c}"
            names[jp + ("downsample_conv",)] = f"{tp}.downsample.0"
            names[jp + ("downsample_bn",)] = f"{tp}.downsample.1"
    for i in range(1, 5):
        for kind in ("inner", "layer"):
            names[("backbone", "fpn", f"fpn_{kind}{i}")] = \
                f"backbone.fpn.fpn_{kind}{i}"
    for fc in ("fc6", "fc7"):
        names[("box_head", fc)] = f"roi_heads.box.feature_extractor.{fc}"
    for name in ("conv", "cls_logits", "bbox_pred"):
        names[("rpn_head", name)] = f"rpn.head.{name}"
    names[("cls_score",)] = "roi_heads.box.predictor.cls_score"
    return names


_LEAF_NAMES = {"mean": "running_mean", "var": "running_var"}


def params_to_state_dict(tree: Mapping[str, Any], cfg: DetectronConfig
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's Detectron param tree ({"backbone": {"body",
    "fpn"}, "box_head"[, "rpn_head", "cls_score"]}, numpy leaves) as a
    maskrcnn-benchmark state dict of fp32 tensors: conv kernels HWIO ->
    OIHW, Dense kernels (in, out) -> Linear weights (out, in), FrozenBN's
    mean / var -> running_mean / running_var."""
    sd: Dict[str, torch.Tensor] = {}
    for path, name in _tree_names(cfg).items():
        node: Any = tree
        for p in path:
            node = node.get(p) if isinstance(node, Mapping) else None
            if node is None:
                break
        if node is None:
            continue
        for leaf, value in node.items():
            arr = np.asarray(value, np.float32)
            if leaf == "kernel":
                arr = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T)
                leaf = "weight"
            sd[f"{name}.{_LEAF_NAMES.get(leaf, leaf)}"] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return sd


def load_detectron_state_dict(model: nn.Module, state_dict: Mapping[str, Any]
                              ) -> nn.Module:
    """Load a maskrcnn-benchmark state dict (a released
    detectron_model.pth's "model", DDP prefixes stripped here) into
    `model`. Keys the model does not hold (the box regressor, a mask
    head) are ignored; a key it holds but the dict lacks raises."""
    from xlxmert_tpu_torch.core.convert import strip_ddp_prefix

    if isinstance(state_dict.get("model"), Mapping):
        state_dict = state_dict["model"]
    sd = strip_ddp_prefix(state_dict)
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"the state dict lacks {len(missing)} of the "
                       f"model's tensors, e.g. {missing[:3]}")
    model.load_state_dict({
        k: sd[k] if isinstance(sd[k], torch.Tensor)
        else torch.from_numpy(np.array(sd[k])) for k in own})
    return model


def load_params(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Load the JAX package's Detectron param tree into a
    DetectronGridExtractor or DetectronDetector (a detector's tree into a
    grid extractor too: the RPN and the predictor are left out)."""
    return load_detectron_state_dict(model,
                                     params_to_state_dict(tree, model.cfg))


def random_params(cfg: DetectronConfig, seed: int = 0,
                  n_classes: Optional[int] = None) -> Dict[str, Any]:
    """A random Detectron param tree in the JAX package's layout (numpy,
    from `seed`): the grid extractor's, plus "rpn_head" and "cls_score"
    when n_classes is given (the detector's). Kernels are normal, scaled
    by 1/sqrt(fan_in); FrozenBN's statistics are drawn too (the JAX init
    sets them to 1 and 0), so the fold is exercised; each block's last
    BN has a small scale, which keeps the residual stream of a deep body
    bounded."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    def conv(k, cin, cout, bias=False):
        out = {"kernel": normal(k, k, cin, cout,
                                scale=1.0 / math.sqrt(k * k * cin))}
        if bias:
            out["bias"] = normal(cout, scale=0.1)
        return out

    def bn(c, gain=1.0):
        return {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32) * gain,
                "bias": normal(c, scale=0.1), "mean": normal(c, scale=0.1),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}

    def dense(cin, cout):
        return {"kernel": normal(cin, cout, scale=1.0 / math.sqrt(cin)),
                "bias": normal(cout, scale=0.1)}

    body: Dict[str, Any] = {"stem_conv1": conv(7, 3, cfg.stem_channels),
                            "stem_bn1": bn(cfg.stem_channels)}
    n_in = cfg.stem_channels
    for s, n_blocks in enumerate(cfg.stage_blocks):
        bott, out = cfg.bottleneck_channels(s), cfg.stage_out_channels[s]
        for b in range(n_blocks):
            block = {"conv1": conv(1, n_in, bott), "bn1": bn(bott),
                     "conv2": conv(3, bott // cfg.num_groups, bott),
                     "bn2": bn(bott), "conv3": conv(1, bott, out),
                     "bn3": bn(out, gain=0.2)}
            if (b == 0 and s > 0) or n_in != out:
                block["downsample_conv"] = conv(1, n_in, out)
                block["downsample_bn"] = bn(out)
            body[f"layer{s + 1}_{b}"] = block
            n_in = out
    fpn = {}
    for i, c in enumerate(cfg.stage_out_channels):
        fpn[f"fpn_inner{i + 1}"] = conv(1, c, cfg.fpn_dim, bias=True)
        fpn[f"fpn_layer{i + 1}"] = conv(3, cfg.fpn_dim, cfg.fpn_dim,
                                        bias=True)
    pooled = cfg.fpn_dim * cfg.pooler_resolution ** 2
    tree = {"backbone": {"body": body, "fpn": fpn},
            "box_head": {"fc6": dense(pooled, cfg.mlp_dim),
                         "fc7": dense(cfg.mlp_dim, cfg.mlp_dim)}}
    if n_classes is not None:
        A = len(ASPECT_RATIOS)
        tree["rpn_head"] = {"conv": conv(3, cfg.fpn_dim, cfg.fpn_dim, True),
                            "cls_logits": conv(1, cfg.fpn_dim, A, True),
                            "bbox_pred": conv(1, cfg.fpn_dim, 4 * A, True)}
        tree["cls_score"] = dense(cfg.mlp_dim, n_classes)
    return tree


# ---------------------------------------------------------------------------
# host-side preprocessing (the reference's image_transform)
# ---------------------------------------------------------------------------

def detectron_resize_shape(h: int, w: int, imsize: int = None,
                           min_size: int = MIN_SIZE,
                           max_size: int = MAX_SIZE) -> Tuple[int, int]:
    """Target (h, w): min-800/max-1333 scaling snapped down to /32
    (coco_extract_grid_feature.py:92-110), or a fixed imsize."""
    if imsize:
        return imsize, imsize
    scale = min_size / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = max_size / max(h, w)
    th = int(scale * h) - int(scale * h) % 32
    tw = int(scale * w) - int(scale * w) % 32
    return max(th, 32), max(tw, 32)


def preprocess_image(img_rgb: np.ndarray, target_hw: Tuple[int, int]
                     ) -> np.ndarray:
    """RGB uint8/float (H, W, 3) -> resized float32 BGR-minus-mean
    (coco_extract_grid_feature.py:76-115). Bilinear, half-pixel centres
    (cv2.INTER_LINEAR)."""
    im = np.asarray(img_rgb, np.float32)
    if im.ndim < 3:
        im = np.repeat(im[:, :, None], 3, axis=2)
    im = im[:, :, ::-1] - np.asarray(PIXEL_MEANS_BGR, np.float32)
    th, tw = target_hw
    if (th, tw) != im.shape[:2]:
        from xlxmert_tpu_torch.models.gan import _interp_matrix

        wh = _interp_matrix(th, im.shape[0])
        ww = _interp_matrix(tw, im.shape[1])
        im = np.einsum("th,hwc->twc", wh, im)
        im = np.einsum("sw,twc->tsc", ww, im)
    return im


def load_weights(model: nn.Module, path: str) -> nn.Module:
    """Load weights from a file into a grid extractor or a detector: a
    maskrcnn-benchmark checkpoint (.pth / .pt / .bin: torch.load, its
    "model" entry), or a msgpack holding either such a state dict (flat
    maskrcnn-benchmark names) or the JAX package's param tree."""
    if path.endswith((".pth", ".pt", ".bin")):
        sd = torch.load(path, map_location="cpu", weights_only=False)
    else:
        from xlxmert_tpu_torch.core.checkpoint import load_pytree

        sd = load_pytree(path)
        if isinstance(sd.get("backbone"), Mapping):
            sd = params_to_state_dict(sd, model.cfg)
    return load_detectron_state_dict(model, sd)
