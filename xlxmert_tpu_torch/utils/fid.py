"""Fréchet distance of generated images (port of xlxmert_tpu/utils/fid.py).

The math runs on the host in float64 (numpy), as the JAX package's does:
mean and covariance of each feature set, and the Fréchet distance with
the symmetrized cross term (S2^1/2 S1 S2^1/2)^1/2 through
eigendecompositions. The features come from a pluggable extractor on
the device:
  - `inception_feature_fn`: InceptionV3 pool3 with pytorch-fid's
    protocol (models/inception), the paper-comparable FID when it holds
    pt_inception's weights;
  - `resnet_feature_fn`: models/resnet's pooled layer4, for relative
    comparisons only.
Both take host batches of NHWC images in [0, 1] and return host float32
(B, D) features.
"""
from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np


def activation_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D))."""
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Square root of a (near-)PSD symmetric matrix through its
    eigendecomposition, tiny negative eigenvalues clipped to 0."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 (S2^1/2 S1 S2^1/2)^1/2), the
    cross term in its symmetrized form (PSD by construction)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64) + eps * np.eye(len(mu1))
    sigma2 = np.asarray(sigma2, np.float64) + eps * np.eye(len(mu2))
    diff = mu1 - mu2
    s2_half = _sqrtm_psd(sigma2)
    covmean = _sqrtm_psd(s2_half @ sigma1 @ s2_half)
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    return frechet_distance(*activation_stats(real),
                            *activation_stats(fake))


def compute_fid(real_batches: Iterable[np.ndarray],
                fake_batches: Iterable[np.ndarray],
                feature_fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """Stream batches of NHWC [0, 1] images through `feature_fn`
    ((B, H, W, 3) -> (B, D)) and compute FID."""
    real = np.concatenate([np.asarray(feature_fn(b)) for b in real_batches])
    fake = np.concatenate([np.asarray(feature_fn(b)) for b in fake_batches])
    return fid_from_features(real, fake)


def _feature_fn(model, device, features):
    import torch

    from xlxmert_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def fn(images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
        return features(model, x).float().cpu().numpy()

    return fn


def inception_feature_fn(model, device="cuda"):
    """The paper-comparable extractor: `model` (models/inception
    InceptionV3, fid_variant) on `device`, pool3 of
    preprocess_for_fid(images). Images not already 299x299 are resized
    on the device (one bilinear, antialias=False resize)."""
    from xlxmert_tpu_torch.models.inception import preprocess_for_fid

    return _feature_fn(model, device,
                       lambda m, x: m(preprocess_for_fid(x)))


def resnet_feature_fn(model, device="cuda"):
    """`model` (models/resnet ResNet) on `device`: the pooled layer4 of
    ImageNet-normalized images. FID under it is for relative comparison
    only, not comparable with Inception FID from the literature."""
    from xlxmert_tpu_torch.models.resnet import normalize_image

    return _feature_fn(model, device, lambda m, x: m(
        normalize_image(x), return_layers=True)["pooled"])
