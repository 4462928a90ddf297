"""Plain explicit ALS (ALS-WR, as MLlib and PredictionIO's recommendation
template train it): from the raw ratings and the initial factors in
original id order, alternate the two ridge solves for ``iterations``.

Half-step for each entity e of one side, with F the other side's factors:
A_e = Σ F_o F_oᵀ and b_e = Σ r F_o over e's ratings (o, r), n_e their
count, and x_e = (A_e + (λ·n_e + 1e-6) I)⁻¹ b_e, the 1e-6 keeping an entity
without ratings at x_e = 0. The sums run in blocks of ratings with
``index_add_``, the solves are batched Cholesky factorizations.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import precision as _precision


def degree_order(entity: np.ndarray, n: int) -> np.ndarray:
    """``perm[e]``: the position of entity e when a side is ordered by
    descending rating count, ties by id. A program that lays its factors
    out so is read back through it."""
    counts = np.bincount(entity, minlength=n)
    order = np.argsort(-counts, kind="stable")
    perm = np.empty(n, np.int64)
    perm[order] = np.arange(n)
    return perm


def normal_equations(entity, other, rating, F_opp, n: int, precision: str,
                     block: int = 1 << 22):
    """(A (n, k, k), b (n, k), cnt (n,)) of one side, in ``precision``'s
    dtype: float64 sums for ``f64``; float32 sums of TF32-rounded factors
    and ratings for ``tf32``."""
    dt = _precision.dtype(precision)
    k = F_opp.shape[1]
    F = F_opp.to(dt)
    if precision == "tf32":
        F = _precision.tf32_round(F)
    A = torch.zeros((n, k * k), dtype=dt, device=F.device)
    b = torch.zeros((n, k), dtype=dt, device=F.device)
    cnt = torch.zeros(n, dtype=dt, device=F.device)
    for s in range(0, len(entity), block):
        e = entity[s:s + block]
        rows = F[other[s:s + block]]
        r = rating[s:s + block].to(dt)
        if precision == "tf32":
            r = _precision.tf32_round(r)
        A.index_add_(0, e, (rows[:, :, None] * rows[:, None, :]).reshape(-1, k * k))
        b.index_add_(0, e, rows * r[:, None])
        cnt.index_add_(0, e, torch.ones_like(r))
    return A.reshape(n, k, k), b, cnt


def ridge_solve(A, b, cnt, reg: float):
    k = A.shape[-1]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    L = torch.linalg.cholesky(A + (reg * cnt + 1e-6)[:, None, None] * eye)
    return torch.cholesky_solve(b[:, :, None], L)[:, :, 0]


def train(user, item, rating, U0, V0, reg: float, iterations: int, precision: str = "f64"):
    """Final (U, V) in original id order, in ``precision``'s dtype.
    ``user``/``item`` are int64 tensors, ``rating`` float32, ``U0``/``V0``
    the (n, rank) initial factors, all on one device."""
    U, V = U0.to(_precision.dtype(precision)), V0.to(_precision.dtype(precision))
    n_users, n_items = U.shape[0], V.shape[0]
    for _ in range(iterations):
        U = ridge_solve(*normal_equations(user, item, rating, V, n_users, precision), reg)
        V = ridge_solve(*normal_equations(item, user, rating, U, n_items, precision), reg)
    return U, V
