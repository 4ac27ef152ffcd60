"""On-device masking for pre-training (port of xlxmert_tpu/ops/masking.py).

The reference masks on the host inside its Dataset/collate
(lxmert_data.py:391-463 visual masks, :697-724 MLM 80/10/10). Here, as in
the JAX package, the masks are drawn on the batch's device inside the
training step, from an explicit `torch.Generator` on that device. The
two packages' random numbers differ, so their masks agree in
distribution and invariants, not in bits.

Documented divergences from the reference, kept from the JAX package:
  - MLM labels use -1 as the ignore value (the reference's data does,
    lxmert_data.py:708); the losses ignore every negative label;
  - pad positions are never selected for MLM masking, and neither are
    the first ([CLS]) and last columns.
"""
from __future__ import annotations

from typing import Tuple

import torch


def random_word_mask(generator: torch.Generator, word_ids: torch.Tensor,
                     mask_rate: float = 0.15, vocab_size: int = 30522,
                     mask_token_id: int = 103, pad_token_id: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT-style 80/10/10 MLM masking. Returns (masked_ids, labels),
    labels -1 at unselected positions."""
    B, L = word_ids.shape
    dev = word_ids.device

    def uniform():
        return torch.rand(B, L, generator=generator, device=dev)

    selected = uniform() < mask_rate
    col = torch.arange(L, device=dev)[None, :]
    protected = (col == 0) | (col == L - 1) | (word_ids == pad_token_id)
    selected = selected & ~protected
    labels = torch.where(selected, word_ids, torch.full_like(word_ids, -1))
    use_mask_tok = uniform() < 0.8
    use_random = ~use_mask_tok & (uniform() < 0.5)
    random_words = torch.randint(0, vocab_size, (B, L), generator=generator,
                                 device=dev, dtype=word_ids.dtype)
    masked = torch.where(selected & use_mask_tok,
                         torch.full_like(word_ids, mask_token_id), word_ids)
    masked = torch.where(selected & use_random, random_words, masked)
    return masked, labels


def uniform_count_vis_mask(generator: torch.Generator, batch: int,
                           n_cells: int, device="cpu") -> torch.Tensor:
    """Mask-predict mask (reference lxmert_data.py:403-419): per sample
    n ~ U{1..n_cells}, then a uniform random subset of exactly n cells,
    as the cells of the n smallest of iid uniform noise. float32
    (batch, n_cells) in {0, 1}."""
    n = torch.randint(1, n_cells + 1, (batch, 1), generator=generator,
                      device=device)
    noise = torch.rand(batch, n_cells, generator=generator, device=device)
    ranks = noise.argsort(-1).argsort(-1)
    return (ranks < n).float()


def square_vis_mask(generator: torch.Generator, batch: int, grid_size: int,
                    device="cpu") -> torch.Tensor:
    """Square-region mask (reference lxmert_data.py:391-401): per sample
    an s x s square, s ~ U{1..G}, its top-left corner uniform over the
    valid range. (batch, G*G) float32."""
    G = grid_size
    s = torch.randint(1, G + 1, (batch, 1, 1), generator=generator,
                      device=device)
    u = torch.rand(2, batch, 1, 1, generator=generator, device=device)
    h0 = torch.floor(u[0] * (G - s + 1)).long()
    w0 = torch.floor(u[1] * (G - s + 1)).long()
    rows = torch.arange(G, device=device)[None, :, None]
    cols = torch.arange(G, device=device)[None, None, :]
    inside = (rows >= h0) & (rows < h0 + s) & (cols >= w0) & (cols < w0 + s)
    return inside.reshape(batch, G * G).float()


def bernoulli_vis_mask(generator: torch.Generator, batch: int, n_cells: int,
                       rate: float = 0.15, device="cpu") -> torch.Tensor:
    """Per-cell Bernoulli mask (reference lxmert_data.py:451-463)."""
    return (torch.rand(batch, n_cells, generator=generator, device=device)
            < rate).float()
