"""Cooccurrence pair-count increments of streaming micro-generations.

Counterpart of ``predictionio_tpu/models/cooccurrence.py:574-623``: the two
numpy functions the delta pipeline (``core/delta.py``) and a replica's
accumulator use. The cooccurrence model family itself is not ported yet
(ROADMAP §1 item 11).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def cooccurrence_increments(items_by_user: dict,
                            prior_by_user: Optional[dict] = None
                            ) -> np.ndarray:
    """Pair-count increments from freshly committed interactions.

    ``items_by_user`` maps a user index to the item indices of that
    user's NEW events only.  ``prior_by_user`` (optional) maps the same
    user to the items the base generation and earlier deltas already
    counted for them.  The increment for each user is
    ``pairs(prior ∪ new) − pairs(prior)``: every unordered pair among
    the genuinely new items, plus every cross pair new×prior, each as a
    ``(item_a, item_b, +count)`` row (``item_a < item_b``).  That is the
    exact delta the full-retrain co-occurrence Gram would gain from
    those events — historical pairs are never re-counted, so a replica
    accumulator fed these increments converges to the next full rebuild
    instead of inflating past it.

    Returns an (m, 3) int64 array, deduplicated and sorted.
    """
    counts: dict = {}
    prior_by_user = prior_by_user or {}
    for user, items in items_by_user.items():
        prior = set(int(i) for i in prior_by_user.get(user, ()))
        new = sorted(set(int(i) for i in items) - prior)
        for i, a in enumerate(new):
            for b in new[i + 1:]:
                counts[(a, b)] = counts.get((a, b), 0) + 1
            for p in prior:
                key = (a, p) if a < p else (p, a)
                counts[key] = counts.get(key, 0) + 1
    if not counts:
        return np.zeros((0, 3), np.int64)
    return np.array(
        [(a, b, c) for (a, b), c in sorted(counts.items())], dtype=np.int64)


def fold_increments(updates: np.ndarray, into: dict) -> dict:
    """Apply delta pair increments to a replica's streaming accumulator.

    ``into`` maps ``(item_a, item_b)`` to the accumulated pending count;
    the replica exposes its size through stats so operators can see how
    much co-occurrence signal is waiting on the next full rebuild."""
    for a, b, c in np.asarray(updates, dtype=np.int64):
        key = (int(a), int(b))
        into[key] = into.get(key, 0) + int(c)
    return into
