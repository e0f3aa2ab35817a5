"""Operations and bytes of the work a step needs, counted from shapes, and
the chip's published peaks they are held against.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates: 989 TFLOP/s
bf16, 1,979 TOP/s int8, 3.35 TB/s HBM. An operation is a multiply or an
add (a multiply-add is 2). Only the work the algorithm needs is counted:
no recomputation, no padding, each input byte read once and each output
byte written once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
PEAK_BYTES_S = 3.35e12


@dataclass(frozen=True)
class Gemm:
    """y[m, n] = x[m, k] @ w[n, k]^T in `prec`."""
    m: int
    n: int
    k: int
    prec: str = "bf16"
    count: int = 1

    @property
    def ops(self) -> float:
        return 2.0 * self.m * self.n * self.k * self.count

    def bytes(self, in_bytes: float, w_bytes: float, out_bytes: float) -> float:
        return self.count * (self.m * self.k * in_bytes + self.n * self.k * w_bytes
                             + self.m * self.n * out_bytes)


@dataclass(frozen=True)
class Attn:
    """softmax(Q K^T) V over `bh` (batch x heads) rows of `sq` queries and
    `skv` keys of width d, Q.K^T in `qk` and P.V in `pv` precision: two
    products of 2 bh sq skv d operations each."""
    bh: int
    sq: int
    skv: int
    d: int
    qk: str = "bf16"
    pv: str = "bf16"
    count: int = 1

    @property
    def product_ops(self) -> float:
        return 2.0 * self.bh * self.sq * self.skv * self.d * self.count

    @property
    def ops(self) -> float:
        return 2 * self.product_ops

    def bound_s(self) -> float:
        return self.product_ops / PEAK_OPS[self.qk] + self.product_ops / PEAK_OPS[self.pv]


@dataclass
class Work:
    """The step's work: GEMMs and attention calls, with how many of each."""
    gemms: List[Gemm] = field(default_factory=list)
    attns: List[Attn] = field(default_factory=list)

    def gemm_bound_s(self, prec: str = None) -> float:
        return sum(g.ops / PEAK_OPS[g.prec] for g in self.gemms
                   if prec is None or g.prec == prec)

    def attn_bound_s(self) -> float:
        return sum(a.bound_s() for a in self.attns)

    def bound_s(self) -> float:
        return self.gemm_bound_s() + self.attn_bound_s()

    def ops(self) -> float:
        return sum(g.ops for g in self.gemms) + sum(a.ops for a in self.attns)


def w8a8_bound_s(gemms: List[Gemm]) -> float:
    """The int8 projections' least time: the larger of their int8 operations
    at peak and their bytes at HBM speed, each summed over the projections.
    Bytes: the bf16 activation read, the int8 weight and its fp32 scales
    read, the bf16 output written."""
    ops = sum(g.ops for g in gemms)
    nbytes = sum(g.bytes(2, 1, 2) + 4 * g.n * g.count for g in gemms)
    return max(ops / PEAK_OPS["int8"], nbytes / PEAK_BYTES_S)


def block_work(tokens: int, width: int, heads: int, head_dim: int, *, batch: int,
               layers: int, lin: str = "bf16", qk: str = "bf16", pv: str = "bf16",
               kv_tokens: int = None) -> Work:
    """`layers` CogVideoX blocks over `batch` sequences of `tokens` joint
    tokens: q, k, v and out projections (4 D x D), the feed-forward (D x 4D
    and 4D x D), and one attention call per block with `kv_tokens` keys
    (the ID resample doubles them)."""
    m = batch * tokens
    d = width
    gemms = [Gemm(m, d, d, lin, 4 * layers), Gemm(m, 4 * d, d, lin, layers),
             Gemm(m, d, 4 * d, lin, layers)]
    attns = [Attn(batch * heads, tokens, kv_tokens or tokens, head_dim, qk, pv, layers)]
    return Work(gemms, attns)
