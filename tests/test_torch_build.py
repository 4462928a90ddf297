"""The kernel build's cache key (``ops/_build._target``): a library is named by
a hash of its source and of every header the source includes from
``csrc/``, so an edit to a shared header builds anew instead of leaving the
card a stale library. And a source of ``_build.SPLIT``: its units compiled
side by side, linked into the one library. Runs on the CPU (no nvcc: only
the names are computed, and a stand-in compiler records its commands)."""

import json
import shutil
import sys

import pytest

from predictionio_tpu_torch.ops import _build

# a stand-in for nvcc: writes its arguments as JSON to its -o target, and
# fails where a unit's macro is PIO_PART=bad
_FAKE_NVCC = """\
import json, sys
args = sys.argv[1:]
if "-DPIO_PART=bad" in args:
    print("unit bad: error")
    sys.exit(2)
out = args[args.index("-o") + 1]
units = [json.load(open(a)) for a in args if a.endswith(".o") and a != out]
with open(out, "w") as f:
    json.dump({"args": args, "units": units}, f)
"""


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


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    (csrc / "w.cu").write_text("// another\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + _FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "build_log", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return out


@pytest.mark.parametrize("parts", [("0", "1", "2"), ("0",)])
def test_split_source_builds_its_units_side_by_side_and_links_them(fake_build, monkeypatch, parts):
    monkeypatch.setattr(_build, "SPLIT", {"k": parts})
    built = _build.build_all(("k", "w"))
    lib = json.loads(built["k"][0].read_text())
    # the link: the whole flags (shared), the units in PIO_PART order
    assert "-shared" in lib["args"] and "-c" not in lib["args"]
    assert [u["args"][u["args"].index("-c") + 1] for u in lib["units"]] == [
        f"-DPIO_PART={p}" for p in parts]
    for u in lib["units"]:  # a unit: compiled only, the source whole
        assert "-shared" not in u["args"] and u["args"][-1].endswith("k.cu")
    # one nvcc for an unsplit source; no unit's object is left behind
    assert json.loads(built["w"][0].read_text())["units"] == []
    assert sorted(p.suffix for p in fake_build.iterdir()) == [".so", ".so"]


def test_split_source_with_a_failed_unit_raises_and_leaves_nothing(fake_build, monkeypatch):
    monkeypatch.setattr(_build, "SPLIT", {"k": ("0", "bad", "2")})
    with pytest.raises(_build.KernelError, match=r"nvcc failed for k\.cu:\n.*unit bad: error"):
        _build.build_all(("k",))
    assert list(fake_build.iterdir()) == []
