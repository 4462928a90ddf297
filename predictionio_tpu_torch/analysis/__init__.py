"""``pio analyze`` pointed at the port: whole-repo static analysis.

Counterpart of ``predictionio_tpu/analysis``: one rule engine, one
suppression mechanism (``# pio: ignore[rule-id]``), one baseline file
(``.pio-torch-analysis-baseline.json``; the JAX package keeps its own).
A checkout's scan covers ``predictionio_tpu_torch/`` and ``chip_smoke.py``
(the role ``bench.py`` plays for the JAX package), against ``docs/*.md`` and
``README.md``, as the JAX package reads them.

The language-level analyzers keep the JAX package's rule ids and logic:

* ``races``    — unguarded shared state reachable from ≥2 thread entry
  points (batcher worker, flush/WAL threads, HTTP handlers, signal
  handlers);
* ``knobs``    — the ``PIO_*`` registry vs the docs: undocumented, dead,
  and default-drifted knobs;
* ``metrics``  — the ``pio_*`` families vs the ``docs/observability.md``
  catalog: undocumented/dead/type-mismatched series, label cardinality;
* ``blocking`` — sleeps/fsyncs/JSON/network calls in the batcher
  dispatch loop and fastpath scoring;
* ``hygiene``  — unused imports, parse health, ad-hoc counters/caches
  (its allow-lists name the port's paths);
* ``lockorder`` and ``deadline`` on the interprocedural call graph
  (:mod:`callgraph`).

The JAX-specific ones take their CUDA/torch form (their module docstrings
say what each rule became): ``hotpath`` — readbacks beyond the answer's
one, device fences outside warm-up, ``nvcc`` builds a request path can
reach; ``collective`` — ``ctypes`` ``argtypes`` against the ``extern "C"``
prototypes of ``csrc/*.cu``, the mesh's axis names, readbacks one call
deep.

Entry points: ``pio analyze`` in the port's CLI, :func:`run` for tests.
"""

from predictionio_tpu_torch.analysis.core import (
    ANALYZER_RULES,
    ANALYZERS,
    BASELINE_NAME,
    Finding,
    Module,
    RepoIndex,
    Report,
    RULES,
    load_baseline,
    run,
    write_baseline,
)
from predictionio_tpu_torch.analysis.core import (
    prune_baseline,
    stale_baseline_keys,
    to_sarif,
)
from predictionio_tpu_torch.analysis import callgraph
from predictionio_tpu_torch.analysis import (  # registers the analyzers
    blocking,
    collective,
    deadline,
    hotpath,
    hygiene,
    knobs,
    lockorder,
    metrics_contract,
    races,
)

__all__ = [
    "ANALYZER_RULES",
    "ANALYZERS",
    "BASELINE_NAME",
    "Finding",
    "Module",
    "RepoIndex",
    "Report",
    "RULES",
    "blocking",
    "callgraph",
    "collective",
    "deadline",
    "hotpath",
    "hygiene",
    "knobs",
    "load_baseline",
    "lockorder",
    "metrics_contract",
    "prune_baseline",
    "races",
    "run",
    "stale_baseline_keys",
    "to_sarif",
    "write_baseline",
]
