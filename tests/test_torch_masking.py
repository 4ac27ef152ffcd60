"""The port's pre-training masks (ops/masking.py) have the JAX masks'
invariants and distributions. The two packages draw different random
numbers, so each property is checked on both implementations, fed the
same word ids, rather than bit for bit.

Statistical bars: a binomial count must lie within 5 standard
deviations of its expectation, and a chi-square goodness-of-fit test
must not reject at p = 1e-4 (a correct mask fails either about once in
ten thousand runs).
"""
import numpy as np
import pytest
from scipy import stats

import jax
import jax.numpy as jnp
import torch

from xlxmert_tpu.ops import masking as jmask
from xlxmert_tpu_torch.ops import masking as tmask

P_MIN = 1e-4
SIGMAS = 5.0


def word_mask(impl, seed, ids, rate=0.15, vocab=100, mask_id=103):
    if impl == "jax":
        m, lab = jmask.random_word_mask(jax.random.PRNGKey(seed),
                                        jnp.asarray(ids), rate,
                                        vocab_size=vocab,
                                        mask_token_id=mask_id)
        return np.asarray(m), np.asarray(lab)
    gen = torch.Generator().manual_seed(seed)
    m, lab = tmask.random_word_mask(gen, torch.from_numpy(ids).long(), rate,
                                    vocab_size=vocab, mask_token_id=mask_id)
    return m.numpy(), lab.numpy()


def vis_mask(impl, kind, seed, batch, n, **kw):
    if impl == "jax":
        fn = getattr(jmask, kind)
        return np.asarray(fn(jax.random.PRNGKey(seed), batch, n, **kw))
    out = getattr(tmask, kind)(torch.Generator().manual_seed(seed), batch, n,
                               **kw)
    assert out.dtype == torch.float32
    return out.numpy()


def within(count, n, p):
    return abs(count - n * p) <= SIGMAS * np.sqrt(n * p * (1 - p))


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_word_mask_protections_and_80_10_10(impl):
    B, L = 2048, 20
    ids = np.full((B, L), 7, np.int64)
    ids[:, 0] = 101
    ids[:, 15:] = 0
    masked, labels = word_mask(impl, 0, ids)
    sel = labels >= 0
    # the first and last columns and the pads are never selected
    assert not sel[:, 0].any() and not sel[:, -1].any()
    assert not sel[:, 15:].any()
    assert (labels[~sel] == -1).all() and (labels[sel] == 7).all()
    assert (masked[~sel] == ids[~sel]).all()
    eligible = B * 14
    assert within(sel.sum(), eligible, 0.15)
    n = int(sel.sum())
    # of the selected: 80 % [MASK], 10 % a random word (which is [MASK]'s
    # id or 7 with probability 1/100 each), the rest unchanged
    is_mask = masked[sel] == 103
    randomized = ~is_mask & (masked[sel] != 7)
    assert within(is_mask.sum(), n, 0.8 + 0.1 * 0.01)
    assert within(randomized.sum(), n, 0.1 * 0.98)
    # the random words are uniform over the vocabulary
    words = masked[sel][randomized]
    assert words.min() >= 0 and words.max() < 100


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_uniform_count_mask_has_exactly_n_cells_n_uniform(impl):
    B, n_cells = 8192, 64
    m = vis_mask(impl, "uniform_count_vis_mask", 1, B, n_cells)
    assert m.shape == (B, n_cells) and set(np.unique(m)) <= {0.0, 1.0}
    counts = m.sum(1).astype(int)
    assert counts.min() >= 1 and counts.max() <= n_cells
    # n ~ U{1..64}: chi-square over the 64 counts
    observed = np.bincount(counts, minlength=n_cells + 1)[1:]
    assert stats.chisquare(observed).pvalue > P_MIN
    # each cell is masked with probability E[n] / 64 = 65 / 128
    per_cell = m.sum(0)
    assert stats.chisquare(per_cell).pvalue > P_MIN


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_square_mask_is_one_contiguous_square(impl):
    B, G = 1024, 8
    m = vis_mask(impl, "square_vis_mask", 2, B, G).reshape(B, G, G)
    sizes = []
    for i in range(B):
        rows = np.flatnonzero(m[i].any(1))
        cols = np.flatnonzero(m[i].any(0))
        assert len(rows) == len(cols) >= 1
        assert (np.diff(rows) == 1).all() and (np.diff(cols) == 1).all()
        assert m[i].sum() == len(rows) ** 2
        sizes.append(len(rows))
    # s ~ U{1..G}
    observed = np.bincount(sizes, minlength=G + 1)[1:]
    assert stats.chisquare(observed).pvalue > P_MIN


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_bernoulli_mask_rate(impl):
    m = vis_mask(impl, "bernoulli_vis_mask", 3, 4096, 64, rate=0.15)
    assert set(np.unique(m)) <= {0.0, 1.0}
    assert within(m.sum(), m.size, 0.15)


def test_torch_masks_follow_the_generator_and_device():
    """The same seed gives the same mask; the mask lies on the batch's
    device."""
    ids = torch.full((4, 12), 5)
    a = tmask.random_word_mask(torch.Generator().manual_seed(9), ids)
    b = tmask.random_word_mask(torch.Generator().manual_seed(9), ids)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    m = tmask.uniform_count_vis_mask(torch.Generator().manual_seed(9), 3,
                                     64, device="cpu")
    assert m.device.type == "cpu" and m.shape == (3, 64)
