"""Batch predict: bulk queries from a file, predictions to a file.

Counterpart of ``predictionio_tpu/serving/batch_predict.py`` (parity:
``core/.../workflow/BatchPredict.scala:120-235``): one JSON query per input
line; each line is parsed → supplemented → predicted per algorithm →
served → rendered as one JSON line. Queries go through
``Algorithm.batch_predict`` in chunks of :data:`_CHUNK_QUERIES`, the
serving fast path's top rung, so on the card each chunk of known users is
one launch of the score kernel. One process writes ``<output>``; the JAX
package's multi-process split into part files waits for multi-GPU
(ROADMAP §1 item 10).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Optional

from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.workflow import (
    get_latest_completed_instance,
    prepare_deploy,
)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.device import DeviceContext
from predictionio_tpu_torch.ops._build import KernelError
from predictionio_tpu_torch.serving.query_server import _to_jsonable, bind_query

logger = logging.getLogger(__name__)

# Queries per engine pass: the serving fast path's top bucket rung
# (serving/fastpath.BUCKETS[-1]), so bulk prediction launches the score
# kernel as the query server's fullest batches do.
_CHUNK_QUERIES = 64


def run_batch_predict(
    engine: Engine,
    input_path: str,
    output_path: str,
    storage: Optional[Storage] = None,
    ctx: Optional[DeviceContext] = None,
    engine_id: str = "default",
    engine_version: str = "default",
    engine_variant: str = "default",
) -> tuple[int, str]:
    """Returns (predictions written, the path written)."""
    storage = storage or Storage.instance()
    ctx = ctx or DeviceContext.create()
    # the FALLIBLE deploy runs before the output opens: a failed run
    # leaves the previous output untouched
    instance = get_latest_completed_instance(
        storage, engine_id, engine_version, engine_variant
    )
    _, algorithms, serving, models = prepare_deploy(
        engine, instance, storage=storage, ctx=ctx
    )
    n = 0
    with open(input_path) as fin, open(output_path, "w") as fout:
        # Queries are CHUNKED through Algorithm.batch_predict — the same
        # vectorized one-device-pass entry point the query server's
        # micro-batcher uses — instead of one predict per line.  Output
        # order stays line order: a chunk flushes before any out-of-band
        # (parse-error) line is written.
        chunk: list[tuple[int, Any, Any]] = []  # (line_no, data, query)

        def write_ok(data, result) -> None:
            nonlocal n
            fout.write(
                json.dumps({"query": data, "prediction": _to_jsonable(result)})
                + "\n"
            )
            n += 1

        def flush() -> None:
            if not chunk:
                return
            try:
                supplemented = [
                    (i, serving.supplement(q))
                    for i, (_, _, q) in enumerate(chunk)
                ]
                per_algo = [
                    dict(a.batch_predict(m, supplemented))
                    for a, m in zip(algorithms, models)
                ]
                for i, (_, data, _q) in enumerate(chunk):
                    preds = [d[i] for d in per_algo if i in d]
                    write_ok(data, serving.serve(supplemented[i][1], preds))
            except KernelError:
                # a kernel's refusal or failure, or a card error, is the
                # card's: it ends the run rather than answering on the host
                raise
            except Exception as batch_err:
                # a poisoned chunk falls back to per-line prediction so one
                # bad query costs one error record, not the whole chunk
                logger.warning(
                    "chunk ending at line %d failed (%s); retrying per line",
                    chunk[-1][0], batch_err,
                )
                for line_no, data, q in chunk:
                    try:
                        sq = serving.supplement(q)
                        preds = [
                            a.predict(m, sq)
                            for a, m in zip(algorithms, models)
                        ]
                        write_ok(data, serving.serve(sq, preds))
                    except KernelError:
                        raise
                    except Exception as e:
                        logger.warning("line %d failed: %s", line_no, e)
                        fout.write(
                            json.dumps({"query": data, "error": str(e)}) + "\n"
                        )
            chunk.clear()

        for line_no, line in enumerate(fin, 1):
            line = line.strip()
            if not line:
                continue
            try:
                data = json.loads(line)
                query = bind_query(engine.query_cls, data)
            except Exception as e:
                logger.warning("line %d failed: %s", line_no, e)
                flush()  # keep output in input-line order
                fout.write(json.dumps({"query": line, "error": str(e)}) + "\n")
                continue
            chunk.append((line_no, data, query))
            if len(chunk) >= _CHUNK_QUERIES:
                flush()
        flush()
    return n, output_path
