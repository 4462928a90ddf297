"""One explicit ALS iteration's operations: both sides' normal equations,
2·(rank² + rank) a rating and side, and each entity's ridge solve, a
Cholesky factorization (rank³/3 multiply-adds) and two triangular solves
(rank² each), at two operations a multiply-add."""


def flops(n_ratings: int, n_users: int, n_items: int, rank: int) -> float:
    normal = 2 * 2.0 * n_ratings * (rank * rank + rank)
    solve = (n_users + n_items) * 2.0 * (rank ** 3 / 3.0 + rank * rank)
    return normal + solve
