"""Kernel 1 (score and top-k): one launch for ``users`` real users over a
catalog of ``n_items`` real items at ``rank``, f32, top ``k``.

Reads each item factor once (n_items·rank·4 B), each user's row and id
(rank·4 + 4 B), and writes each answer's index and score (k·8 B a user).
Operations: 2·users·n_items·rank. Padded items and padded rows of a rung
belong to the implementation and are not counted."""


def cost(users: int, n_items: int, rank: int, k: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one launch."""
    flops = 2.0 * users * n_items * rank
    nbytes = 4.0 * n_items * rank + users * (4.0 * rank + 4.0) + users * k * 8.0
    return flops, nbytes
