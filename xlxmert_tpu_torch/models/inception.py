"""InceptionV3 pool3, the FID feature extractor (port of
xlxmert_tpu/models/inception.py).

torchvision's structure and names (`Conv2d_1a_3x3.conv`, `.bn`,
`Mixed_5b.branch1x1`, ..., `fc`; BasicConv2d = a bias-free conv, BN with
eps 1e-3, ReLU), so a torchvision `inception_v3_google-*.pth` (1,000
classes) or pytorch-fid's `pt_inception-2015-12-05-*.pth` (1,008
classes, the weights every published FID uses) loads through
`torchvision_state_dict` with its `AuxLogits.*` dropped, and the JAX
module's {params, batch_stats} through `load_variables`.

`fid_variant=True` (the default) takes pytorch-fid's patches of the TF
graph: the in-block 3x3 average pools leave the padding out of the
divisor (count_include_pad=False), and Mixed_7c's pool branch is a
padded 3x3 max pool (Mixed_7b keeps the average). The stem's and the
reduction blocks' 3x3 / stride-2 max pools are unpadded.

The forward takes NHWC images in [-1, 1] (`preprocess_for_fid` makes
them from [0, 1]) and returns pool3, the spatial mean of Mixed_7c,
(N, 2048). Inside, the layout is channels-last: the kernels are stored
so, and an NHWC batch seen as NCHW has channels-last strides already,
so cuDNN's convolutions, the BN and the pools all run channels-last
(PERF.md gives the time against NCHW that decided it).

BN is the frozen `_BN` of models/resnet (the running statistics).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xlxmert_tpu_torch.models.resnet import _BN

Pair = Tuple[int, int]


class BasicConv2d(nn.Module):
    """conv (bias-free) + BN(eps=1e-3) + ReLU."""

    def __init__(self, in_features: int, features: int, kernel: Pair,
                 strides: Pair = (1, 1), padding: Pair = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel, strides,
                              padding, bias=False)
        self.bn = _BN(features, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg3(x: torch.Tensor, fid_variant: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=not fid_variant)


def _max3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)    # VALID padding


class InceptionA(nn.Module):
    def __init__(self, in_features: int, pool_features: int,
                 fid_variant: bool = True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(in_features, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(in_features, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_features, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(in_features, pool_features, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg3(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_features: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_features, 384, (3, 3), (2, 2))
        self.branch3x3dbl_1 = BasicConv2d(in_features, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), (2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_features: int, channels_7x7: int,
                 fid_variant: bool = True):
        super().__init__()
        c7 = channels_7x7
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(in_features, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(in_features, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_features, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_features, 192, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                     self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg3(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_features: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_features, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), (2, 2))
        self.branch7x7x3_1 = BasicConv2d(in_features, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), (2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max3s2(x)], 1)


class InceptionE(nn.Module):
    """pool_mode "max" is pytorch-fid's Mixed_7c: a padded 3x3 max pool in
    the pool branch (with fid_variant); Mixed_7b keeps the average."""

    def __init__(self, in_features: int, pool_mode: str = "avg",
                 fid_variant: bool = True):
        super().__init__()
        self.pool_mode, self.fid_variant = pool_mode, fid_variant
        self.branch1x1 = BasicConv2d(in_features, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(in_features, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_features, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_features, 192, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        if self.pool_mode == "max" and self.fid_variant:
            bp = F.max_pool2d(x, 3, 1, 1)     # -inf padding, as flax's
        else:
            bp = _avg3(x, self.fid_variant)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """forward(x, return_logits=False): x (N, 299, 299, 3) in [-1, 1] ->
    pool3 (N, 2048), or the fc head's logits (N, num_classes): 1,008
    for pt_inception's weights, 1,000 for torchvision's."""

    def __init__(self, num_classes: int = 1008, fid_variant: bool = True):
        super().__init__()
        fv = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), (2, 2))
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32, fv)
        self.Mixed_5c = InceptionA(256, 64, fv)
        self.Mixed_5d = InceptionA(288, 64, fv)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fv)
        self.Mixed_6c = InceptionC(768, 160, fv)
        self.Mixed_6d = InceptionC(768, 160, fv)
        self.Mixed_6e = InceptionC(768, 192, fv)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", fv)
        self.Mixed_7c = InceptionE(2048, "max", fv)
        self.fc = nn.Linear(2048, num_classes)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor,
                return_logits: bool = False) -> torch.Tensor:
        h = self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x.permute(0, 3, 1, 2)))
        h = _max3s2(self.Conv2d_2b_3x3(h))
        h = _max3s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h)))
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                      self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                      self.Mixed_7b, self.Mixed_7c):
            h = block(h)
        pool3 = h.mean(dim=(2, 3))
        if return_logits:
            # flax's Dense: the product, then the bias
            return pool3 @ self.fc.weight.t() + self.fc.bias
        return pool3


def preprocess_for_fid(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] NHWC images -> 299x299 in [-1, 1] (pytorch-fid's protocol: a
    bilinear resize without antialiasing, then x * 2 - 1). The JAX
    package's jax.image.resize agrees with it to < 1e-4."""
    if tuple(images.shape[1:3]) != (299, 299):
        images = F.interpolate(images.permute(0, 3, 1, 2), size=(299, 299),
                               mode="bilinear", align_corners=False,
                               antialias=False).permute(0, 2, 3, 1)
    return images * 2.0 - 1.0


# -- weights ------------------------------------------------------------------

def _torch_name(path: Tuple[str, ...], value: np.ndarray
                ) -> Tuple[str, np.ndarray]:
    """A flax leaf of this module's tree -> its torch name and value:
    kernel (kh, kw, in, out) -> weight (out, in, kh, kw), the fc's
    kernel (in, out) -> weight (out, in), a BN's scale -> weight (the
    tree has no list indices, so nothing folds)."""
    leaf = path[-1]
    if leaf == "kernel":
        value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(path[:-1] + (leaf,)), value


def load_variables(model: InceptionV3, variables: Mapping) -> InceptionV3:
    """Load the JAX InceptionV3's {"params", "batch_stats"} (numpy leaves;
    also a converted torchvision state dict split by
    core/convert.split_variables) into `model`, strictly, but for the fc
    head, which the JAX module creates only when asked for logits."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                name, arr = _torch_name(path + (k,), np.asarray(v))
                sd[name] = torch.from_numpy(
                    np.array(arr, dtype=np.float32, order="C"))

    for col in ("params", "batch_stats"):
        walk(variables.get(col, {}), ())
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [m for m in missing if not m.startswith("fc.")]
    if missing or unexpected:
        raise ValueError(f"InceptionV3 variables: missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    return model


def variables_of(model: InceptionV3) -> Dict[str, Dict]:
    """`load_variables`' inverse: the module's {"params", "batch_stats"}
    in the JAX layout (numpy)."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        arr = t.detach().cpu().numpy()
        col = "params"
        if leaf in ("mean", "var"):
            col = "batch_stats"
        elif leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif leaf == "weight":
            leaf = "scale"
        node = out[col]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out


def torchvision_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision or pt_inception state dict -> this module's: the
    checkpoint-only AuxLogits and the BN step counters dropped, running
    statistics named as _BN's buffers (the JAX package's
    convert_inception_state_dict does the same on its side)."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("AuxLogits.") or k.endswith("num_batches_tracked"):
            continue
        k = k.replace(".running_mean", ".mean").replace(".running_var",
                                                        ".var")
        out[k] = torch.as_tensor(v).float()
    return out


def random_variables(seed: int, num_classes: int = 1008) -> Dict[str, Dict]:
    """Random InceptionV3 variables in the JAX layout from numpy's
    generator: He-normal conv kernels, BN statistics and affine drawn
    about the identity (so every block sees O(1) activations), an
    N(0, 0.01) fc. They cannot equal flax's PRNGKey init: FID under them
    is only comparable to FID under the same seed."""
    rng = np.random.default_rng(seed)
    model = InceptionV3(num_classes)
    tree = variables_of(model)

    def draw(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                draw(v, path + (k,))
                continue
            shape = v.shape
            if k == "kernel" and len(shape) == 4:
                fan_in = shape[0] * shape[1] * shape[2]
                a = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            elif k == "kernel":
                a = rng.standard_normal(shape) * 0.01
            elif k == "scale":
                a = rng.uniform(0.8, 1.2, shape)
            elif k == "mean":
                a = rng.standard_normal(shape) * 0.1
            elif k == "var":
                a = rng.uniform(0.75, 1.25, shape)
            else:   # bias
                a = rng.standard_normal(shape) * 0.05
            node[k] = a.astype(np.float32)

    draw(tree, ())
    return tree


def inception_from_variables(variables: Mapping,
                             fid_variant: bool = True) -> InceptionV3:
    """An InceptionV3 holding `variables` (its class count from the fc
    kernel, 1,008 without one), in eval mode on the CPU."""
    fc = variables.get("params", {}).get("fc", {}).get("kernel")
    n = 1008 if fc is None else int(np.shape(fc)[1])
    return load_variables(InceptionV3(n, fid_variant), variables).eval()
