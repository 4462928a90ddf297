"""A cell, a mix, a limit set and a metric are added as files and entries
only: the harness finds them by name, with no edit of a file it has."""

import json
import shutil

from conftest import ROOT, TINY_ALS

from portbench import harness


def test_new_config_mix_and_metric_are_files_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = tmp_path / "portbench"
    config = json.loads((bench_dir / "configs" / "als-ml25m.json").read_text())
    (bench_dir / "configs" / "als-small.json").write_text(
        json.dumps({**config, "name": "als-small", **TINY_ALS}))
    (bench_dir / "mixes" / "bulk-top-10.json").write_text(json.dumps(
        {"mode": "bulk", "num": 10, "chunk": 16, "check_chunks": 3, "trace_units": 2}))
    (bench_dir / "limits" / "als-small-bulk.json").write_text(
        json.dumps({"rank_gap": 1e-5, "value_gap": 1e-5}))
    (bench_dir / "metrics" / "chunks_per_s.py").write_text(
        "def read(run):\n    return run.counts['chunks'] / run.window_s\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "als-small", "source": "https://example.org/als-small",
                             "file": "portbench/configs/als-small.json", "reduced": [],
                             "why": "a small catalog"})
    bench["workloads"].append({"name": "als-small-bulk", "config": "als-small",
                               "traffic": "bulk-top-10", "chips": 1, "why": "top 10"})
    bench["end_to_end"].append({"name": "chunks_per_s", "unit": "chunks/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["als-small-bulk"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    result = harness.run_cell("als-small-bulk", 3, 0.3, False, root=tmp_path, device="cpu")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"chunks_per_s", "setup_s"}
    assert result["metrics"]["chunks_per_s"]["value"] > 0
    assert list(result)[-1] == "checks"


def test_every_cell_resolves_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        files = harness.CellFiles(cell["name"])
        assert files.mix["mode"]
        assert files.limits
        for kind in ("end_to_end", "per_layer"):
            for m in files.metrics(kind):
                assert hasattr(harness.reader(ROOT, m["name"]), "read")
