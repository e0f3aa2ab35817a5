"""The operation and byte counters against the kernel-table bounds that
chip_smoke's arithmetic gave (PERF.md's kernel table)."""

import _paths  # noqa: F401
import pytest

from vpbench.counts import Attn, Gemm, PEAK_OPS, Work, block_work, w8a8_bound_s

S = 17_776


def test_b1_bound_at_the_flagship_shape():
    assert Attn(2 * 48, S, S, 64).bound_s() * 1e3 == pytest.approx(7.852, abs=5e-4)


@pytest.mark.parametrize("skv,pv,ms", [(2 * S, "bf16", 11.776), (2 * S, "int8", 7.848),
                                       (S, "bf16", 5.888), (S, "int8", 3.924)])
def test_b4_bounds(skv, pv, ms):
    assert Attn(2 * 48, S, skv, 64, "int8", pv).bound_s() * 1e3 == pytest.approx(ms, abs=5e-4)


def test_a_served_bf16_step_counts_6_96e14_operations():
    w = block_work(S, 3072, 48, 64, batch=2, layers=44)
    assert w.ops() == pytest.approx(6.96e14, rel=2e-3)
    assert w.bound_s() == pytest.approx(w.ops() / PEAK_OPS["bf16"])


def test_w8a8_bound_takes_the_larger_of_compute_and_bytes():
    big = [Gemm(2 * S, 3072, 3072, "int8", 4)]
    assert w8a8_bound_s(big) == pytest.approx(big[0].ops / PEAK_OPS["int8"])
    thin = [Gemm(2 * S, 8, 8, "int8")]   # bytes dominate
    nbytes = 2 * S * 8 * 2 + 8 * 8 + 2 * S * 8 * 2 + 4 * 8
    assert w8a8_bound_s(thin) == pytest.approx(nbytes / 3.35e12)


def test_work_sums_by_precision():
    w = Work([Gemm(10, 10, 10, "int8"), Gemm(10, 10, 10)], [Attn(1, 4, 4, 2)])
    assert w.gemm_bound_s("int8") == pytest.approx(2000 / PEAK_OPS["int8"])
    assert w.bound_s() == pytest.approx(2000 / PEAK_OPS["int8"] + 2000 / PEAK_OPS["bf16"]
                                        + 2 * 64 / PEAK_OPS["bf16"])
