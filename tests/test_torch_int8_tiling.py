"""The index math of the stride-1 int8 conv template (``csrc/int8_conv.cu``
``conv_s1_wgmma_kernel``, kernels 4 and 6), emulated with torch ops on the
CPU and held against the plain versions that ``tests/test_torch_int8.py`` and
``tests/test_torch_base_model.py`` hold against the JAX package.

The template computes the output over the padded grid's width: row m = oy *
Wp + ox of image b, for tap (ky, kx), reads flat row b * Hp * Wp + m + ky *
Wp + kx of the (B * Hp * Wp, Cp) int8 view (a TMA box; past the last image
it reads zeros), in k-slabs of 128 channels whose products stop at Cp; the
columns ox >= Wo and the rows m >= Ho * Wp are dropped. Per image and M tile
of 128 rows it writes int64 partials of the accumulators and their squares
over the kept rows, which the stats launch adds (the squares
as 32-bit halves) and turns into f64 moments. Exact integers throughout:
the tests compare with ``torch.equal``.

No card and no JAX are needed. The template's tile sizes are restated here
(``M_TILE``, ``K_SLAB``); ``tests/test_torch_int8_gpu.py`` checks that the
library tiles as ``M_TILE`` says.
"""
import math

import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.ops.kernels import int8_conv as kq

torch.set_num_threads(2)

K_SLAB = 128  # channels per TMA box of the template (kWK)
M_TILE = 128  # rows m = oy * Wp + ox per M tile of the template (kWM)


def _tiles(hp: int, wp: int) -> int:
    return math.ceil((hp - 2) * wp / M_TILE)


def _case(b, c, co, h, w, padding, seed):
    rng = np.random.default_rng(seed)
    weight = torch.from_numpy((rng.standard_normal((co, c, 3, 3)) * 0.1).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(co) * 0.2).astype(np.float32))
    qc = kq.quant_conv(weight, bias, 2.5, 1, padding)
    x = torch.from_numpy((rng.standard_normal((b, c, h, w)) * 1.5).astype(np.float32))
    return kq.quant_pad_plain(x, qc), qc


def flat_acc(xq: torch.Tensor, qc: kq.QuantConv) -> torch.Tensor:
    """(B, tiles * M_TILE, R) accumulators over the padded width, as the
    template sums them: flat row shifts per tap, 128-channel slabs."""
    b, hp, wp, cp = xq.shape
    rows = _tiles(hp, wp) * M_TILE
    flat = xq.reshape(b * hp * wp, cp).double()
    # the last tile of the last image reads past the tensor: TMA's zero fill
    flat = torch.cat([flat, flat.new_zeros(rows + 2 * wp + 2, cp)])
    w = qc.w.double()  # (R, 9, Cp)
    acc = torch.zeros((b, rows, w.shape[0]), dtype=torch.float64)
    for i in range(b):
        for tap in range(9):
            start = i * hp * wp + (tap // 3) * wp + tap % 3
            for c0 in range(0, cp, K_SLAB):
                c1 = min(c0 + K_SLAB, cp)  # the k32 steps of the slab that hold channels
                acc[i] += flat[start:start + rows, c0:c1] @ w[:, tap, c0:c1].T
    return acc.to(torch.int64)


def kept(acc: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """The rows the epilogue stores: (B, R, Ho, Wo) of the flat accumulators."""
    b, _, r = acc.shape
    ho, wo = hp - 2, wp - 2
    return acc[:, :ho * wp].reshape(b, ho, wp, r)[:, :, :wo].permute(0, 3, 1, 2)


def tile_partials(acc: torch.Tensor, hp: int, wp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, tiles, R) int64 sums of the accumulators and their squares over
    each tile's kept rows."""
    b, rows, r = acc.shape
    m = torch.arange(rows)
    keep = ((m // wp < hp - 2) & (m % wp < wp - 2)).to(torch.int64)[None, :, None]
    a = acc * keep
    tiles = rows // M_TILE
    return (a.reshape(b, tiles, -1, r).sum(2), (a * a).reshape(b, tiles, -1, r).sum(2))


def stats_from_partials(psum, psq, qc: kq.QuantConv, hw: int):
    """The stats launch (``stats_kernel``): the partials added, the squares
    as 32-bit halves, each total rounded once to f64, then the f64 moments."""
    d1 = psum.sum(1).double()
    d2 = (psq >> 32).sum(1).double() * 2.0**32 + (psq & 0xFFFFFFFF).sum(1).double()
    sc = qc.scale.double()
    bi = torch.zeros_like(sc) if qc.bias is None else qc.bias.double()
    s = sc * d1 + float(hw) * bi
    q = (sc * sc) * d2 + ((2.0 * sc) * bi) * d1 + float(hw) * (bi * bi)
    return s.float(), q.float()


# (B, C, Co, H, W, padding): the flagship width; DecoderConcat's 268 (Cp 288: a
# 32-channel tail slab; R 268: a second N tile of 12 rows); Cp 320 (a 64-channel
# tail slab); an odd batch; Ho * Wp off the M tile; Wp above the M tile; one row
# with zero padding
CASES = {
    "c256": (2, 256, 256, 6, 10, "reflect"),
    "c268_tail_slab_and_n_tile": (1, 268, 268, 5, 7, None),
    "c300_tail_slab_64": (1, 300, 44, 4, 5, "reflect"),
    "odd_batch": (3, 40, 24, 7, 9, "reflect"),
    "ragged_m_tile": (2, 64, 96, 9, 13, "reflect"),
    "wp_above_m_tile": (1, 32, 40, 3, 140, "reflect"),
    "h1_zero_pad": (2, 24, 24, 1, 9, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_flat_row_shifts_give_the_plain_accumulators(name):
    b, c, co, h, w, padding = CASES[name]
    xq, qc = _case(b, c, co, h, w, padding, seed=len(name))
    acc = flat_acc(xq, qc)
    want = kq.conv_acc_plain(xq, qc).to(torch.int64)
    assert torch.equal(kept(acc, h + 2, w + 2), want)


@pytest.mark.parametrize("name", list(CASES))
def test_tile_partials_give_the_plain_statistics(name):
    b, c, co, h, w, padding = CASES[name]
    xq, qc = _case(b, c, co, h, w, padding, seed=10 + len(name))
    psum, psq = tile_partials(flat_acc(xq, qc), h + 2, w + 2)
    assert psum.shape == (b, _tiles(h + 2, w + 2), co)
    # a tile's sum of squares fits in int64 with room: the wrapper's bound
    assert psq.max() < 2**63 // 2
    got = stats_from_partials(psum, psq, qc, h * w)
    want = kq.stats_plain(kq.conv_acc_plain(xq, qc), qc)
    assert all(torch.equal(g, r) for g, r in zip(got, want))


def test_the_nhwc_output_is_for_stride_one_only():
    """Only the wgmma route stores NHWC; the refusal comes before any launch."""
    down = kq.quant_conv(torch.ones(8, 8, 3, 3), None, 1.0, 2, "reflect")
    xq = torch.zeros((1, 10, 10, down.cp), dtype=torch.int8)
    with pytest.raises(ValueError, match="NHWC"):
        kq.conv_padded_cuda(xq, down, nhwc=True)
