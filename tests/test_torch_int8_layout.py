"""The int8 P.V operand layout of the wgmma int8 flash kernel
(`videopainter_tpu_torch/csrc/flash_int8_wgmma.cu`), modelled in numpy.

The kernel's score accumulator (wgmma m64n128k32, s32) and the A fragment of
its int8 P.V product (wgmma m64n64k32 s8, A from registers) hold different
keys in a thread's registers: the accumulator 2 consecutive keys of each
8-key chunk, the A fragment 4 consecutive k positions per register. The
kernel packs P from the accumulator without a shuffle, so the wrapper writes
V^T with its key columns permuted (`kernel_vt`), and at
every k position it must hold the key whose probability the packed register
holds there. Both register layouts are the PTX ISA's wgmma fragments for
(warp, g = lane / 4, t = lane % 4, register). The same file models the
kernel's two conversions without I2F / F2I and its paged key mask without a
division. Plain numpy and CPU tensors.
"""

import itertools

import numpy as np
import pytest
import torch

from videopainter_tpu_torch import _kernels
from videopainter_tpu_torch.ops import flash_attention_int8 as fa8

TILE = 128          # keys per tile of the kernel (its S accumulator is m64n128)
# the kernel's code: its source and the int8 kernels' common header it includes
SOURCE = "".join((_kernels.CSRC / name).read_text()
                 for name in ("flash_int8_wgmma.cu", "int8_wgmma.cuh"))


def acc_position(warp, g, t, i):
    """(row, key in the tile) of accumulator register i of a m64nN wgmma
    (s32 or f32 alike)."""
    return 16 * warp + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)


def a_frag_position(warp, g, t, r, byte):
    """(row, k) of byte `byte` of A register r of a m64nNk32 8-bit wgmma."""
    return 16 * warp + g + 8 * (r & 1), 16 * (r >> 1) + 4 * t + byte


def packed_register(kk, r, byte):
    """The accumulator register that the kernel's pack_p<true> puts into byte
    `byte` of pa[kk][r]: pack_p8(f(i), f(i + 1), f(i + 4), f(i + 5)) with
    i = 16 kk + 8 (r >> 1) + 2 (r & 1)."""
    return 16 * kk + 8 * (r >> 1) + 2 * (r & 1) + (0, 1, 4, 5)[byte]


def vt_keys(s_k):
    """The key at each column of the wrapper's V^T (-1: padding), read by
    running the layout function on key indices."""
    keys = torch.arange(s_k, dtype=torch.int64)[None, None, :, None]
    vt = fa8.kernel_vt(keys + 1, TILE)    # + 1: 0 marks padding
    return vt[0, 0, 0].numpy() - 1


def test_the_model_packs_what_the_kernel_packs():
    assert "const int i = 16 * kk + 8 * (r >> 1) + 2 * (r & 1);" in SOURCE
    assert "pack_p8(f(i), f(i + 1), f(i + 4), f(i + 5))" in SOURCE
    assert "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8" in (
        _kernels.CSRC / "hopper.cuh").read_text()


@pytest.mark.parametrize("warp", range(4))
def test_permuted_vt_holds_at_every_k_the_key_the_accumulator_holds(warp):
    """For every thread and byte of the packed P: the accumulator register it
    comes from sits in the same row as the A fragment byte it lands in, and
    the V^T column of that k position holds that register's key."""
    col_key = vt_keys(TILE)
    seen = np.zeros((64, TILE), dtype=np.int64)
    for g, t, kk, r, byte in itertools.product(range(8), range(4), range(4), range(4), range(4)):
        row_acc, key = acc_position(warp, g, t, packed_register(kk, r, byte))
        row_a, k = a_frag_position(warp, g, t, r, byte)
        position = 32 * kk + k
        assert row_acc == row_a
        assert col_key[position] == key, (g, t, kk, r, byte)
        seen[row_a, position] += 1
    # each of the warp's 16 rows has every position of the tile exactly once
    assert (seen[16 * warp:16 * warp + 16] == 1).all()
    assert seen.sum() == 16 * TILE


def test_the_permutation_stays_inside_each_16_key_group():
    assert sorted(fa8.PERM16) == list(range(16))
    assert fa8.PERM16 == (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)
    keys = vt_keys(3 * TILE)
    assert (keys // 16 == np.arange(3 * TILE) // 16).all()


@pytest.mark.parametrize("s_k", [1, 17, 65, 128, 300])
def test_layout_pads_with_zeros_and_keeps_every_key(s_k):
    keys = vt_keys(s_k)
    pad = -(-s_k // TILE) * TILE
    assert keys.shape == (pad,)
    assert sorted(keys[keys >= 0]) == list(range(s_k))
    assert (keys < 0).sum() == pad - s_k


@pytest.mark.parametrize("s_k", [16, 65, 300, 1000])
def test_int8_pv_product_over_the_permuted_vt_is_the_natural_one(s_k):
    """round(P * 127) (columns permuted alike) times the permuted V^T equals
    the natural int8 product exactly, in total and per 128-key tile (the
    kernel scales each tile's product by its block's sv)."""
    rng = np.random.default_rng(s_k)
    rows, d = 24, 64
    p8 = torch.from_numpy(rng.integers(0, 128, (rows, s_k), dtype=np.int8))
    v8 = torch.from_numpy(rng.integers(-127, 128, (s_k, d), dtype=np.int8))
    vt = fa8.kernel_vt(v8[None, None], TILE)[0, 0]          # [d, pad]
    pt = fa8.kernel_vt(p8.T.contiguous()[None, None], TILE)[0, 0]   # [rows, pad]
    assert vt.dtype == torch.int8 and vt.shape == (d, -(-s_k // TILE) * TILE)
    natural = p8.long() @ v8.long()
    assert torch.equal(pt.long() @ vt.long().T, natural)
    for c0 in range(0, s_k, TILE):
        want = p8[:, c0:c0 + TILE].long() @ v8[c0:c0 + TILE].long()
        got = pt[:, c0:c0 + TILE].long() @ vt[:, c0:c0 + TILE].long().T
        assert torch.equal(got, want)


def s32_to_f32(s):
    """The kernel's int32 -> fp32: __int_as_float(s + 0x4B400000) - 12582912.f"""
    bits = (s.astype(np.int64) + 0x4B400000).astype(np.uint32)
    return bits.view(np.float32) - np.float32(12582912.0)


@pytest.mark.parametrize("bound", [64 * 127 * 127, 128 * 127 * 127])
def test_int32_to_fp32_without_i2f_is_exact(bound):
    """Every score (|s| <= 64 * 127^2) and every tile's P.V sum (|s| <=
    128 * 127^2) is below 2^22, where the trick is exact."""
    assert bound < 2 ** 22
    rng = np.random.default_rng(bound)
    s = np.concatenate([np.arange(-bound, -bound + 2000), np.arange(-1000, 1000),
                        np.arange(bound - 2000, bound + 1),
                        rng.integers(-bound, bound + 1, 100_000)]).astype(np.int32)
    out = s32_to_f32(s)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, s.astype(np.float32))


def test_p_rounding_without_f2i_is_round_half_even():
    """fmaf(p, 127, 1.5 * 2^23): one rounding of the exact p * 127 (the FMA,
    modelled in float64, where p * 127 + 2^23 * 1.5 is exact); its low byte
    is round(p * 127) half to even, for p in [0, 1]."""
    rng = np.random.default_rng(0)
    halves = (np.arange(128) + 0.5) / 127    # near the ties
    p = np.concatenate([rng.random(200_000), np.linspace(0, 1, 10_001),
                        np.nextafter(halves, 0), halves, np.nextafter(halves, 1),
                        [0.0, 1.0]]).astype(np.float32)
    p = p[(p >= 0) & (p <= 1)]
    fma = (p.astype(np.float64) * 127 + 12582912.0).astype(np.float32)
    low = (fma.view(np.uint32) & 0xFF).astype(np.int64)
    np.testing.assert_array_equal(low, np.rint(p.astype(np.float64) * 127).astype(np.int64))
    assert low.max() == 127


def valid_keys(s_k, kv_len, kv_page, n0, t, page_off):
    """The kernel's valid_keys: the validity of the thread's 32 columns
    n0 + 8c + 2t + e of a tile, the page offset stepped by additions."""
    bits = []
    for c in range(16):
        for e in range(2):
            col = n0 + 8 * c + 2 * t + e
            off = page_off + e if page_off + e < kv_page else page_off + e - kv_page
            bits.append(col < s_k and off < kv_len)
        page_off += 8
        while page_off >= kv_page:
            page_off -= kv_page
    return bits


@pytest.mark.parametrize("kv_page", [1, 3, 8, 9, 127, 128, 400])
def test_paged_mask_without_division_is_the_modulo_mask(kv_page):
    """Paged validity (col < S_k) & (col % kv_page < kv_len), with the page
    offset of each thread's first column carried from tile to tile by
    additions (`next_page`) and stepped across the tile (`valid_keys`)."""
    assert "while (page_off >= p.kv_page) page_off -= p.kv_page;" in SOURCE
    assert "col % p.kv_page" not in SOURCE
    s_k = 3 * kv_page + 50
    for kv_len in sorted({1, max(1, kv_page // 2), kv_page}):
        for t in range(4):
            page_off = 2 * t % kv_page
            for n0 in range(0, s_k, TILE):
                want = [n0 + 8 * c + 2 * t + e < s_k and (n0 + 8 * c + 2 * t + e) % kv_page < kv_len
                        for c in range(16) for e in range(2)]
                assert valid_keys(s_k, kv_len, kv_page, n0, t, page_off) == want
                page_off = (page_off + TILE) % kv_page
