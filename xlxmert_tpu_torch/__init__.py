"""PyTorch + CUDA port of xlxmert_tpu for NVIDIA Hopper GPUs.

The JAX package `xlxmert_tpu` is the reference: this package mirrors its
layout (core/, ops/, serving/, data/, utils/, cli/) so that each module
has one counterpart, and imports nothing of it. The TPU's Pallas kernels
become CUDA kernels under csrc/, built at first use (ops/_build.py).
Entry points run on the card unless the caller passes device="cpu",
where every kernel wrapper takes its plain PyTorch version.
"""
