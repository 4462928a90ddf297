"""predictionio_tpu_torch: the PyTorch/CUDA port of ``predictionio_tpu``.

The JAX package beside this one is the reference. This package keeps its
module layout and names (``ops/topk.py`` here is the counterpart of
``predictionio_tpu/ops/topk.py``) but imports neither jax nor anything of
``predictionio_tpu``: what it needs from the JAX package it carries as its
own copy.

Entry points place tensors on the CUDA device unless the caller passes
``device="cpu"`` (what the CPU tests do). On the card every scoring call
launches the hand-written kernel under ``csrc/``; a tensor on the CPU takes
the kernel's plain PyTorch version instead.
"""

__version__ = "0.1.0"
