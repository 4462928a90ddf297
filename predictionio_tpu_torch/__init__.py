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

The top-level names load lazily, as in the JAX package (nothing heavy is
imported with the package). ``MeshContext`` is the mesh of one process
(``parallel/mesh.py``).
"""

__version__ = "0.1.0"

# Lazy top-level conveniences (no heavy imports at package load).
_LAZY_EXPORTS = {
    "Event": "predictionio_tpu_torch.data",
    "DataMap": "predictionio_tpu_torch.data",
    "BiMap": "predictionio_tpu_torch.data",
    "EventBatch": "predictionio_tpu_torch.data.batch",
    "Storage": "predictionio_tpu_torch.data.storage",
    "PEventStore": "predictionio_tpu_torch.data.store",
    "LEventStore": "predictionio_tpu_torch.data.store",
    "Engine": "predictionio_tpu_torch.core",
    "EngineFactory": "predictionio_tpu_torch.core",
    "EngineParams": "predictionio_tpu_torch.core",
    "MeshContext": "predictionio_tpu_torch.parallel",
}


def __getattr__(name):
    module_name = _LAZY_EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(f"module 'predictionio_tpu_torch' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module_name), name)
    globals()[name] = value  # cache: later accesses are plain lookups
    return value


def __dir__():
    return sorted(list(globals()) + list(_LAZY_EXPORTS))
