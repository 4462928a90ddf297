"""Kernel 2 (the dense normal equations) over one ALS iteration: both
half-steps, explicit feedback, f32.

Each side reads, for every real rating, the opposite entity's id and the
rating (8 B), each opposite factor row once (rank·4 B), and writes A, b and
the count of every entity of the side ((rank² + rank + 1)·4 B). Operations:
2·(rank² + rank) a rating and side. Padded slots of the degree buckets and
their masks belong to the implementation and are not counted."""


def cost(n_ratings: int, n_users: int, n_items: int, rank: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one iteration's two half-steps."""
    out = (rank * rank + rank + 1) * 4.0
    nbytes = 0.0
    for n_side, n_opp in ((n_users, n_items), (n_items, n_users)):
        nbytes += 8.0 * n_ratings + 4.0 * rank * n_opp + out * n_side
    flops = 2 * 2.0 * n_ratings * (rank * rank + rank)
    return flops, nbytes
