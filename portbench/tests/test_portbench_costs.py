"""The cost functions at shapes checked by hand."""

import pytest

from portbench.costs import als_iteration, attention, kernel1, kernel2, peaks, sasrec_step


def test_kernel2_ml25m_iteration():
    flops, nbytes = kernel2.cost(25_000_095, 162_541, 59_047, 10)
    # per side: 8 B a rating, the opposite rows at 40 B, A b cnt at 444 B
    users = 8 * 25_000_095 + 40 * 59_047 + 444 * 162_541
    items = 8 * 25_000_095 + 40 * 162_541 + 444 * 59_047
    assert nbytes == users + items == 507_250_112
    assert flops == 2 * 2 * 25_000_095 * 110
    t, what = peaks.bound_s(flops, nbytes)
    assert what == "bytes" and t == pytest.approx(507_250_112 / 3.35e12)


def test_kernel1_chunk_of_64():
    flops, nbytes = kernel1.cost(64, 59_047, 10, 100)
    assert nbytes == 59_047 * 40 + 64 * 44 + 64 * 800
    assert flops == 2 * 64 * 59_047 * 10
    assert peaks.bound_s(flops, nbytes) == (pytest.approx(nbytes / 3.35e12), "bytes")


def test_kernel1_counts_real_users_only():
    assert kernel1.cost(45, 59_047, 10, 100)[1] < kernel1.cost(64, 59_047, 10, 100)[1]


def test_attention_layer_at_256():
    flops, nbytes = attention.cost(128, 256, 50)
    assert nbytes == 12 * 128 * 256 * 50 * 4
    assert flops == 6 * 128 * 256 * 256 * 50
    assert peaks.bound_s(flops, nbytes)[1] == "bytes"


def test_als_iteration_flops():
    k = 10
    expect = 4 * 25_000_095 * (k * k + k) + (162_541 + 59_047) * 2 * (k ** 3 / 3 + k * k)
    assert als_iteration.flops(25_000_095, 162_541, 59_047, k) == pytest.approx(expect)


def test_sasrec_step_flops():
    b, t, d, n_items = 128, 256, 50, 3416
    loss = 20_000
    expect = 3 * (2 * 24 * b * t * d * d + 2 * 2 * b * t * t * d + 2 * loss * d * n_items)
    assert sasrec_step.flops(b, t, d, 2, n_items, loss) == pytest.approx(expect)


def test_operations_bound_when_bytes_are_few():
    assert peaks.bound_s(495e12, 1.0) == (pytest.approx(1.0), "operations")
