"""The kernel build's cache key (``ops/_build._target``): a library is named by
a hash of its source and of every header the source includes from
``csrc/``, so an edit to a shared header builds anew instead of leaving the
card a stale library. Runs on the CPU (no nvcc: only the names are
computed)."""

import shutil

from predictionio_tpu_torch.ops import _build


def test_sources_follow_the_shared_header():
    for name in ("flash_fwd", "flash_bwd"):
        assert [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")] == [
            f"{name}.cu", "mma_tf32.cuh"]
    assert [p.name for p in _build._sources(_build.CSRC / "score_topk.cu")] == ["score_topk.cu"]


def test_header_edit_gives_a_new_target(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build._target(n, csrc, tmp_path) for n in _build.SOURCES}
    assert before == {n: _build._target(n, csrc, tmp_path) for n in _build.SOURCES}  # stable
    header = csrc / "mma_tf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n, csrc, tmp_path) for n in _build.SOURCES}
    changed = {n for n in _build.SOURCES if after[n] != before[n]}
    assert changed == {"flash_fwd", "flash_bwd"}
    # a header included by a header is followed too
    (csrc / "inner.cuh").write_text("#pragma once\n")
    header.write_text(header.read_text() + '#include "inner.cuh"\n')
    mid = _build._target("flash_fwd", csrc, tmp_path)
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert _build._target("flash_fwd", csrc, tmp_path) != mid
