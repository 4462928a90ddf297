"""The reading of a profiler trace, on a trace written by hand."""

import pytest

from portbench import harness


def _trace():
    X = "X"
    return {"traceEvents": [
        {"ph": X, "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 100,
         "tid": 1},
        {"ph": X, "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 10, "tid": 1},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 8, "dur": 2, "tid": 1,
         "args": {"correlation": 1}},
        {"ph": X, "cat": "kernel", "name": "void (anonymous namespace)::score_select<float, 1>(A)",
         "ts": 20, "dur": 30, "args": {"correlation": 1}},
        {"ph": X, "cat": "cpu_op", "name": "autograd::engine::evaluate_function: IndexBackward0",
         "ts": 40, "dur": 30, "tid": 2},
        {"ph": X, "cat": "cpu_op", "name": "aten::index_put_", "ts": 45, "dur": 10, "tid": 2},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 50, "dur": 2, "tid": 2,
         "args": {"correlation": 2}},
        {"ph": X, "cat": "kernel", "name": "void at::native::indexing_backward_kernel<float>(x)",
         "ts": 60, "dur": 20, "args": {"correlation": 2}},
        {"ph": X, "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 85, "dur": 15,
         "tid": 1},
    ]}


def test_busy_and_window():
    p = harness.Profile(_trace(), units=2)
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx(50e-6)


def test_kernels_by_name_and_by_launching_range():
    p = harness.Profile(_trace(), units=2)
    assert p.kernel_events(("score_select",)) == [(20.0, 50.0)]
    assert p.device_s_under("IndexBackward0") == pytest.approx(20e-6)
    assert p.device_s_under("aten::mm") == pytest.approx(30e-6)
    assert dict(p.device_ops()) == pytest.approx(
        {"score_select": 30e-6, "indexing_backward_kernel": 20e-6})


def test_idle_time_goes_to_the_innermost_open_range():
    gaps = dict(harness.Profile(_trace(), units=2).idle_gaps())
    # idle: [0, 20) under the window, mm and the launch; [50, 60) under the
    # launch, index_put_ and the backward node; [80, 100) the window, the sync
    assert gaps["portbench.window"] == pytest.approx(15e-6)
    assert gaps["autograd::engine::evaluate_function: IndexBackward0"] == pytest.approx(5e-6)
    assert gaps["aten::mm"] == pytest.approx(8e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(4e-6)
    assert gaps["aten::index_put_"] == pytest.approx(3e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(15e-6)
    assert sum(gaps.values()) == pytest.approx(50e-6)


def test_idle_between_consecutive_kernels_leaves_out_device_work():
    trace = _trace()
    X = "X"
    trace["traceEvents"] += [
        {"ph": X, "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 52, "dur": 3,
         "args": {"correlation": 3}},
        {"ph": X, "cat": "kernel", "name": "score_select<float, 1>(B)", "ts": 90, "dur": 5,
         "args": {"correlation": 4}},
    ]
    p = harness.Profile(trace, units=2)
    # from 50 to 90: busy 52-55 (the copy) and 60-80 (the other kernel)
    assert p.idle_between(("score_select",)) == [pytest.approx(17.0)]


def _run(events: int, launches: int):
    trace = _trace()
    trace["traceEvents"] += [
        {"ph": "X", "cat": "kernel", "name": "score_select<float, 1>(B)", "ts": 90 + i,
         "dur": 1, "args": {"correlation": 10 + i}} for i in range(events - 1)]
    return harness.Run(profile=harness.Profile(trace, units=2),
                       kernels={"kernel1": (("score_select",), ("score_select",))},
                       trace_launches={"kernel1": launches}, trace_counts={"units": 2})


def test_kernel_seconds_only_where_events_number_the_launches(capsys):
    assert _run(2, 2).kernel_seconds("kernel1")[0] == pytest.approx(31e-6)
    assert _run(2, 3).kernel_seconds("kernel1") == (None, None)
    assert "2 profiler events for 3 launches" in capsys.readouterr().err


def test_idle_share_is_not_clamped():
    run = _run(2, 2)
    run.rest_counts, run.rest_s = {"units": 10}, 100e-6
    # busy 51 µs over 2 traced units, 10 units in 100 µs: an impossible reading shows
    assert run.idle_percent() == pytest.approx(100.0 * (1 - 51e-6 / 2 * 10 / 100e-6))
    assert run.idle_percent() < 0
