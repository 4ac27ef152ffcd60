"""Device selection for the port's entry points."""
from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; with
    no card this raises instead of silently running the plain PyTorch
    versions, which only run where the caller asks for the CPU. A rank
    of a multi-process launch (LOCAL_RANK set) gets card
    LOCAL_RANK % the host's cards, so ranks sharing one card all take
    cuda:0."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch versions of its kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device(
            "cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    return dev
