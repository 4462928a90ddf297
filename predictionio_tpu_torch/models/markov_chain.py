"""First-order Markov chain: top-N transition model.

Counterpart of ``predictionio_tpu/models/markov_chain.py`` (parity:
``e2/.../engine/MarkovChain.scala:25-87``): transition counts are one
segment count over ``from·S + to`` on the context's device, rows are
normalized, and each state keeps its top-N successors in ``lax.top_k``'s
order (``ops/topk.topk_two_key``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops.segment import segment_count
from predictionio_tpu_torch.ops.topk import topk_two_key


@dataclasses.dataclass
class MarkovChainModel:
    top_states: np.ndarray  # (S, N) successor state indices
    top_probs: np.ndarray  # (S, N) transition probabilities

    def transition(self, state: int, n: Optional[int] = None):
        idx = self.top_states[state]
        p = self.top_probs[state]
        keep = p > 0
        idx, p = idx[keep], p[keep]
        return (idx[:n], p[:n]) if n is not None else (idx, p)


def train_markov_chain(
    ctx, from_states: np.ndarray, to_states: np.ndarray, n_states: int, top_n: int = 10
) -> MarkovChainModel:
    if n_states * n_states >= 2**31:
        raise ValueError(
            f"n_states={n_states} needs {n_states * n_states} transition "
            "cells, exceeding int32 indexing; shard the state space first"
        )
    dev = (ctx or DeviceContext.create()).device
    flat = from_states.astype(np.int64) * n_states + to_states.astype(np.int64)
    counts = (
        segment_count(torch.from_numpy(flat).to(dev), n_states * n_states)
        .cpu().numpy().reshape(n_states, n_states)
    )
    row_sums = counts.sum(axis=1, keepdims=True)
    probs = np.divide(
        counts, row_sums, out=np.zeros_like(counts), where=row_sums > 0
    )
    vals, idx = topk_two_key(torch.from_numpy(probs).to(dev), min(top_n, n_states))
    return MarkovChainModel(
        top_states=idx.cpu().numpy().astype(np.int32),
        top_probs=vals.cpu().numpy().astype(np.float32),
    )
