"""Static-shape helpers of the device mesh.

Counterpart of ``predictionio_tpu/parallel/mesh.py``, holding only
:func:`pad_to_multiple`: the mesh itself (``MeshContext``, ``make_mesh``)
comes with the multi-GPU slice (ROADMAP §1 item 10).
"""

from __future__ import annotations

import math


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= max(n, 1) — static-shape padding."""
    return max(1, math.ceil(max(n, 1) / m)) * m
