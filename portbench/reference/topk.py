"""Plain top-k recommendation: every item's score u·v for each user, the
``k`` best by score, ties to the smaller index."""

from __future__ import annotations

import torch

from portbench.reference import precision as _precision


def scores(U: torch.Tensor, V: torch.Tensor, users: torch.Tensor, precision: str) -> torch.Tensor:
    """(len(users), n_items) scores in ``precision``."""
    dt = _precision.dtype(precision)
    return _precision.matmul(U[users].to(dt), V.to(dt).T, precision)


def top_k(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(indices, values) of each row's ``k`` best, by value descending,
    then index ascending."""
    # a stable sort by value keeps equal values in index order
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return order, s.gather(1, order)
