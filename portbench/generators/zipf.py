"""Traffic recipes, frozen here so that a change to the program cannot move
the benchmark's inputs.

Copied from ``chip_smoke.py`` (``zipf_mandelbrot_weights``,
``zipf_interactions``, ``ml1m_interactions``) with two changes: each returns
plain arrays, which the adapters hand to the program in its own types, and
the ML-1M history lengths are one fixed set, shuffled by the seed.

:func:`zipf_ratings_torch` is the same ML-25M recipe drawn with torch from
one ``torch.Generator`` (on the card in a benchmark run): each Zipf draw is
the inverse of the weights' cumulative sum at a uniform variate, as
``numpy.random.Generator.choice`` draws with ``p``.
"""

from __future__ import annotations

import numpy as np
import torch


def zipf_mandelbrot_weights(n: int, s: float, q: float = 50.0) -> np.ndarray:
    """Zipf-Mandelbrot pmf ``P(k) ∝ (k+q)^-s`` over ranks ``[0, n)``."""
    p = (np.arange(1, n + 1, dtype=np.float64) + q) ** -s
    return p / p.sum()


def zipf_interactions(seed: int, n_users: int, n_items: int, n_ratings: int):
    """The synthetic ML-25M recipe at the given size, on the host:
    ``(user, item, rating)``, users Zipf s 0.7, items s 1.1 (q 50), ratings
    uniform on [1, 5)."""
    rng = np.random.default_rng(seed)
    user = rng.choice(n_users, size=n_ratings, p=zipf_mandelbrot_weights(n_users, 0.7))
    item = rng.choice(n_items, size=n_ratings, p=zipf_mandelbrot_weights(n_items, 1.1))
    rating = rng.uniform(1.0, 5.0, n_ratings).astype(np.float32)
    return user, item, rating


def _zipf_draw(n: int, s: float, q: float, size: int, gen: torch.Generator, device):
    cdf = torch.from_numpy(np.cumsum(zipf_mandelbrot_weights(n, s, q))).to(device)
    u = torch.rand(size, generator=gen, dtype=torch.float64, device=device)
    return torch.searchsorted(cdf, u, right=True).clamp_max_(n - 1)


def zipf_ratings_torch(gen: torch.Generator, n_users: int, n_items: int, n_ratings: int,
                       user_s: float = 0.7, item_s: float = 1.1, q: float = 50.0,
                       low: float = 1.0, high: float = 5.0):
    """:func:`zipf_interactions`'s recipe on ``gen``'s device: ``(user int64,
    item int64, rating float32)`` tensors."""
    device = gen.device
    user = _zipf_draw(n_users, user_s, q, n_ratings, gen, device)
    item = _zipf_draw(n_items, item_s, q, n_ratings, gen, device)
    rating = torch.rand(n_ratings, generator=gen, dtype=torch.float32, device=device)
    return user, item, rating * (high - low) + low


def ml1m_lengths(n_users: int = 6040, n_events: int = 1_000_209,
                 min_events: int = 20) -> np.ndarray:
    """Every user's history length: ``min_events`` and a log-normal share of
    the rest, taken at the n quantiles of the log-normal (not drawn), so the
    set of lengths is the same for every seed; the remainder goes one each
    to the largest fractional shares."""
    from statistics import NormalDist

    spread = n_events - min_events * n_users
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n_users) for i in range(n_users)])
    share = np.exp(z) / np.exp(z).sum() * spread
    extra = np.floor(share).astype(np.int64)
    extra[np.argsort(-(share - extra), kind="stable")[:spread - int(extra.sum())]] += 1
    return min_events + extra


def ml1m_interactions(seed: int, n_users: int = 6040, n_events: int = 1_000_209,
                      min_events: int = 20, n_items: int = 3416):
    """Events in MovieLens-1M's shape: ``n_events`` views of ``n_users``
    users over ``n_items`` items, every user at least ``min_events`` (the
    rest spread log-normally), items Zipf-Mandelbrot (s 1.1, q 50), times
    increasing along each history. The seed shuffles which user has which
    of :func:`ml1m_lengths` and draws the items: ``chip_smoke.py`` draws the
    lengths too, which made the work of a training step change with the
    seed. Returns ``(user, item, t, lengths)``."""
    rng = np.random.default_rng(seed + 11)
    lengths = rng.permutation(ml1m_lengths(n_users, n_events, min_events))
    user = np.repeat(np.arange(n_users), lengths)
    item = rng.choice(n_items, size=len(user), p=zipf_mandelbrot_weights(n_items, 1.1))
    t = np.arange(len(user)) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    return user, item, 1_767_225_600.0 + t, lengths
