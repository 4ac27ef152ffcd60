"""The one traffic generator: rows of WordPiece ids whose lengths follow
a mix over buckets, each with an image pick, cut into batches.

A mix is a data file, `portbench/traffic/<mix>.json`:

    pool          rows in the pool, which the window cycles through
    length_mix    {bucket length: share of rows}; a row's token count
                  ([CLS] + words + [SEP]) is uniform inside its bucket,
                  above the next shorter bucket (or `min_tokens`)
    min_tokens    the shortest row
  or
    words         a published statistic of the rows' lengths in words:
                  {"mean", "sd", "min", "extra_tokens"}; a row has
                  round(W) words, W normal with that mean and standard
                  deviation, at least `min`, and `extra_tokens` more
                  tokens than words; rows longer than the longest
                  bucket are cut to it, as the tokenizer cuts them
    buckets       the bucket lengths the `words` rows are routed to
    route         "bucket": a batch holds rows of one bucket, padded to
                  the bucket's length (cli/serve's routing); "pad": every
                  row padded to the longest bucket
    batch         rows a batch
    ahead         batches dispatched before the oldest one's answers are
                  fetched (cli/serve's --window); 0: one batch at a time
    images        "catalog": a uniform pick of a catalog row per row;
                  "none"

Every seed gets the same number of rows in each bucket (its share of
`pool`, rounded up to whole batches), and the same sequence of batch lengths (a batch of the
longest length first, then a smooth weighted round robin over the
buckets); the seed draws the words, the
token counts inside each bucket (uniform, or by the `words` statistic)
and the image picks. The copy of
chip_smoke.py's `synthetic_questions` this started from drew bucket
counts at random, which changed the work from seed to seed.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

CLS, SEP, FIRST_WORD = 101, 102, 999


class Batch(NamedTuple):
    length: int          # text length the batch is padded to
    rows: np.ndarray     # pool rows (batch,)


class Traffic(NamedTuple):
    ids: np.ndarray          # (pool, longest bucket) int64, 0-padded
    picks: Optional[np.ndarray]  # (pool,) catalog rows, or None
    batches: List[Batch]     # the cycle, in dispatch order


def word_shares(params: Dict) -> Dict[int, float]:
    """{token count: share of rows} of a `words` mix."""
    w = params["words"]
    mean, sd, extra = float(w["mean"]), float(w["sd"]), int(w["extra_tokens"])
    longest = max(int(b) for b in params["buckets"])

    def cdf(x: float) -> float:
        return 0.5 * (1.0 + math.erf((x - mean) / (sd * math.sqrt(2.0))))

    out: Dict[int, float] = {}
    for n in range(int(w["min"]), longest - extra + 1):
        # round(W) = n; the longest count takes every longer row
        top = 1.0 if n == longest - extra else cdf(n + 0.5)
        out[n + extra] = top - cdf(n - 0.5)
    total = sum(out.values())
    return {t: p / total for t, p in out.items()}


def bucket_shares(params: Dict
                  ) -> Dict[int, Tuple[float, Optional[Dict[int, float]]]]:
    """{bucket: (share of rows, {token count: share inside the bucket},
    or None where the count is uniform inside it)}."""
    if "words" not in params:
        return {int(k): (float(v), None)
                for k, v in params["length_mix"].items()}
    shares = word_shares(params)
    out, lo = {}, min(shares)
    for b in sorted(int(b) for b in params["buckets"]):
        inside = {t: p for t, p in shares.items() if lo <= t <= b}
        total = sum(inside.values())
        out[b] = (total, {t: p / total for t, p in inside.items()})
        lo = b + 1
    return out


def generate(params: Dict, seed: int, vocab_size: int,
             n_images: int = 0) -> Traffic:
    mix = bucket_shares(params)
    buckets = sorted(mix)
    B = int(params["batch"])
    rng = np.random.default_rng(int(seed))
    counts = [B * int(np.ceil(params["pool"] * mix[b][0] / B))
              for b in buckets]
    lows = [int(params.get("min_tokens", 1))] + [b + 1 for b in buckets[:-1]]
    n_tok = np.concatenate([
        rng.integers(lo, b + 1, size=n) if mix[b][1] is None else
        rng.choice(np.array(list(mix[b][1]), np.int64), size=n,
                   p=np.array(list(mix[b][1].values())))
        for lo, b, n in zip(lows, buckets, counts)])
    pool, L = int(sum(counts)), buckets[-1]
    ids = rng.integers(FIRST_WORD, vocab_size, size=(pool, L),
                       dtype=np.int64)
    col = np.arange(L)[None, :]
    ids[:, 0] = CLS
    ids[col == (n_tok[:, None] - 1)] = SEP
    ids[col >= n_tok[:, None]] = 0
    picks = None
    if params["images"] == "catalog":
        picks = rng.integers(0, n_images, size=pool, dtype=np.int64)
    starts = np.cumsum([0] + counts)
    per_bucket = [[Batch(b if params["route"] == "bucket" else L,
                         np.arange(s, s + B))
                   for s in range(starts[j], starts[j + 1], B)]
                  for j, b in enumerate(buckets)]
    # the longest batch first, as cli/serve orders them, then the rest
    # interleaved
    order = [per_bucket[-1][0]] + round_robin(per_bucket[:-1]
                                              + [per_bucket[-1][1:]])
    return Traffic(ids, picks, order)


def round_robin(groups: List[List[Batch]]) -> List[Batch]:
    """Interleave the groups so that every prefix holds each group in
    about its share (smooth weighted round robin)."""
    total = sum(len(g) for g in groups)
    taken = [0] * len(groups)
    out = []
    for k in range(1, total + 1):
        j = max(range(len(groups)),
                key=lambda i: (len(groups[i]) * k / total - taken[i]
                               if taken[i] < len(groups[i]) else -1e9))
        out.append(groups[j][taken[j]])
        taken[j] += 1
    return out


def host_batches(traffic: Traffic, torch, pin: bool):
    """Each batch of the cycle as the program takes it: token ids (B, L)
    int64, catalog rows (B,) int64 and the mask (B, L) fp32, views of
    one (pinned) host tensor a kind."""
    picks = (traffic.picks if traffic.picks is not None
             else np.zeros(traffic.ids.shape[0], np.int64))
    # one contiguous tensor a batch length, over the rows of that length
    spans: Dict[int, List[int]] = {}
    for b in traffic.batches:
        lo, hi = spans.setdefault(b.length, [b.rows[0], b.rows[-1] + 1])
        spans[b.length] = [min(lo, b.rows[0]), max(hi, b.rows[-1] + 1)]
    held = {}
    for length, (lo, hi) in spans.items():
        ids = torch.from_numpy(np.ascontiguousarray(
            traffic.ids[lo:hi, :length]))
        kinds = [ids, torch.from_numpy(picks[lo:hi].copy()),
                 (ids > 0).float()]
        held[length] = (lo, [t.pin_memory() if pin else t for t in kinds])
    out = []
    for b in traffic.batches:
        lo, (ids, pk, mask) = held[b.length]
        a, z = int(b.rows[0]) - lo, int(b.rows[-1]) + 1 - lo
        out.append((ids[a:z], pk[a:z], mask[a:z]))
    return out
