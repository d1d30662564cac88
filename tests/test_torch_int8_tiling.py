"""The index math of the int8 conv template (``csrc/int8_conv.cu``:
``conv_s1_wgmma_kernel``, the stride-1 conv of kernels 4 and 6;
``conv_box_kernel``, the stride-2 conv of kernel 7 and the transposed conv
of kernel 5), emulated with torch ops on the CPU and held against the plain versions that
``tests/test_torch_int8.py`` and ``tests/test_torch_base_model.py`` hold
against the JAX package.

The template computes the output over the padded grid's width: row m = oy *
Wp + ox of image b, for tap (ky, kx), reads flat row b * Hp * Wp + m + ky *
Wp + kx of the (B * Hp * Wp, Cp) int8 view (a TMA box; past the last image
it reads zeros), in k-slabs of 128 channels whose products stop at Cp; the
columns ox >= Wo and the rows m >= Ho * Wp are dropped. Per image and M tile
of 128 rows it writes int64 partials of the accumulators and their squares
over the kept rows, which the stats launch adds (the squares
as 32-bit halves) and turns into f64 moments. Exact integers throughout:
the tests compare with ``torch.equal``.

The stride-2 and transposed convs' addressing is set out beside their tests
below. No card and no JAX are needed. The template's tile sizes are restated
here (``M_TILE``, ``K_SLAB``, ``BOX_NW``, ``box_tile``, ``box_launches``);
``tests/test_torch_int8_gpu.py`` checks that the library tiles as they say.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.ops.kernels import int8_conv as kq

torch.set_num_threads(2)

K_SLAB = 128  # channels per TMA box of the template (kWK)
M_TILE = 128  # rows m = oy * Wp + ox per M tile of the template (kWM)


def _tiles(hp: int, wp: int, k: int = 3) -> int:
    return math.ceil((hp - k + 1) * wp / M_TILE)


def _case(b, c, co, h, w, padding, seed):
    rng = np.random.default_rng(seed)
    weight = torch.from_numpy((rng.standard_normal((co, c, 3, 3)) * 0.1).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(co) * 0.2).astype(np.float32))
    qc = kq.quant_conv(weight, bias, 2.5, 1, padding)
    x = torch.from_numpy((rng.standard_normal((b, c, h, w)) * 1.5).astype(np.float32))
    return kq.quant_pad_plain(x, qc), qc


def flat_acc(xq: torch.Tensor, qc: kq.QuantConv) -> torch.Tensor:
    """(B, tiles * M_TILE, R) accumulators over the padded width, as the
    template sums them: flat row shifts per tap (a 3x3 or, for the
    transposed conv, a 2x2 conv), 128-channel slabs."""
    b, hp, wp, cp = xq.shape
    k = qc.kw
    rows = _tiles(hp, wp, k) * M_TILE
    flat = xq.reshape(b * hp * wp, cp).double()
    # the last tile of the last image reads past the tensor: TMA's zero fill
    flat = torch.cat([flat, flat.new_zeros(rows + 2 * wp + 2, cp)])
    w = qc.w.double()  # (R, k * k, Cp)
    acc = torch.zeros((b, rows, w.shape[0]), dtype=torch.float64)
    for i in range(b):
        for tap in range(k * k):
            start = i * hp * wp + (tap // k) * wp + tap % k
            for c0 in range(0, cp, K_SLAB):
                c1 = min(c0 + K_SLAB, cp)  # the k32 steps of the slab that hold channels
                acc[i] += flat[start:start + rows, c0:c1] @ w[:, tap, c0:c1].T
    return acc.to(torch.int64)


def kept(acc: torch.Tensor, hp: int, wp: int, k: int = 3) -> torch.Tensor:
    """The rows the epilogue stores: (B, R, Ho, Wo) of the flat accumulators."""
    b, _, r = acc.shape
    ho, wo = hp - k + 1, wp - k + 1
    return acc[:, :ho * wp].reshape(b, ho, wp, r)[:, :, :wo].permute(0, 3, 1, 2)


def tile_partials(acc: torch.Tensor, hp: int, wp: int, k: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, tiles, R) int64 sums of the accumulators and their squares over
    each tile's kept rows."""
    b, rows, r = acc.shape
    m = torch.arange(rows)
    keep = ((m // wp < hp - k + 1) & (m % wp < wp - k + 1)).to(torch.int64)[None, :, None]
    a = acc * keep
    tiles = rows // M_TILE
    return (a.reshape(b, tiles, -1, r).sum(2), (a * a).reshape(b, tiles, -1, r).sum(2))


def stats_from_partials(psum, psq, qc: kq.QuantConv, hw: int):
    """The stats launch (``stats_kernel``): the partials added, the squares
    as 32-bit halves, each total rounded once to f64, then the f64 moments
    per row; for a transposed conv the rows of channel co, 4 co + ph, added
    in f64 in the phase order ph = 2 py + px = 0, 1, 2, 3."""
    d1 = psum.sum(1).double()
    d2 = (psq >> 32).sum(1).double() * 2.0**32 + (psq & 0xFFFFFFFF).sum(1).double()
    sc = qc.scale.double()
    bi = torch.zeros_like(sc) if qc.bias is None else qc.bias.double()
    s_rows = sc * d1 + float(hw) * bi
    q_rows = (sc * sc) * d2 + ((2.0 * sc) * bi) * d1 + float(hw) * (bi * bi)
    co = qc.cout
    s = q = torch.zeros((psum.shape[0], co), dtype=torch.float64)
    for ph in range(qc.phases):
        rows = [c if qc.phases == 1 else 4 * c + ph for c in range(co)]
        s, q = s + s_rows[:, rows], q + q_rows[:, rows]
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


# ------------------------- the stride-2 and transposed convs (kernels 7, 5)
#
# Their M tiles are boxes of by output rows x bx output columns (``box_tile``:
# bx = 32, 64 or 128, the least that holds Wo, or 128; by = min(128 // bx,
# Ho)). Tap (ky, kx)'s A rows are one TMA box, zeros past each dim, which
# lands as tile rows r = ly bx + lx:
# - stride 2: the padded input (Hp, Wp even: ``kq.padded_size``) as (B Hp /
#   2, 2, Wp / 2, 2, Cp), outermost first, row and column parities apart: box
#   (by, 1, bx, 1, slab) at (b Hp / 2 + oy0 + ky // 2, ky & 1, ox0 + kx // 2,
#   kx & 1, c0);
# - transposed: a 2x2 conv over the input padded by one zero row and column
#   at the end, as (B Hp, Wp, Cp): box (by, bx, slab) at (b Hp + oy0 + ky, ox0
#   + kx, c0), to R = 4 Co weight rows n = 4 co + 2 py + px
#   (``kq.phase_row``).
# The N tiles are BOX_NW = 128 rows wide, all in one launch, and a tail of R
# is a launch of its own at the narrowest wgmma width (kNW = 128, 64 or 32)
# that holds it, whose weight box reads zeros past R (``box_launches``). The
# epilogue finds tile row r's box pixel by shifts, (r >> log2 bx, r & (bx -
# 1)), stages the tile from n0 in chunks of 32 output columns (``chunk_rows``
# rows of 128 bytes) and stores each chunk that holds columns inside the box
# as one box, clipped at the array's dims:
# - stride 2: chunk j's row c by + ly (kNW by rows) -> y[b, n0 + c, oy0 + ly,
#   ox0 + 32 j + x];
# - transposed: chunk j's row (co by + ly) 2 + py (kNW / 2 by rows) -> y[b,
#   n0 / 4 + co, 2 (oy0 + ly) + py, 2 ox0 + 32 j + x], x = 2 ox + px.

BOX_NW = 128  # the box conv's N tile (kBoxNW)


def box_tile(ho: int, wo: int) -> tuple[int, int]:
    bx = 32 if wo <= 32 else 64 if wo <= 64 else M_TILE
    return bx, min(M_TILE // bx, ho)


def box_tiles(ho: int, wo: int) -> int:
    bx, by = box_tile(ho, wo)
    return math.ceil(ho / by) * math.ceil(wo / bx)


def box_launches(r: int) -> list:
    """(first row n0, N tiles, width kNW) of each conv launch (``conv_box``)."""
    full, tail = divmod(r, BOX_NW)
    out = [(0, full, BOX_NW)] if full else []
    if tail:
        out.append((full * BOX_NW, 1, 128 if tail > 64 else 64 if tail > 32 else 32))
    return out


def box_row_pixel(r: int, bx: int) -> tuple[int, int]:
    """Tile row r's box pixel (ly, lx), by the epilogue's shifts."""
    lg = 7 if bx == 128 else 6 if bx == 64 else 5
    return r >> lg, r & (bx - 1)


def tma_box(view: torch.Tensor, start, box) -> torch.Tensor:
    """``view[start : start + box]`` along every dim (outermost first), with
    zeros where the box runs past a dim, as TMA fills it."""
    out = view.new_zeros(box)
    src = tuple(slice(s, min(s + n, d)) for s, n, d in zip(start, box, view.shape))
    dst = tuple(slice(0, max(0, sl.stop - sl.start)) for sl in src)
    out[dst] = view[src]
    return out


def box_corners(ho: int, wo: int):
    """Each tile's (oy0, ox0), tile by tile."""
    bx, by = box_tile(ho, wo)
    tiles_x = math.ceil(wo / bx)
    return [(t // tiles_x * by, t % tiles_x * bx) for t in range(box_tiles(ho, wo))]


def box_pixels(ho: int, wo: int) -> torch.Tensor:
    """(tiles, M_TILE): each M-tile row's output pixel oy * Wo + ox as the
    epilogue decodes the row, or -1 for a row it keeps out (past the box, Ho
    or Wo)."""
    bx, by = box_tile(ho, wo)
    corners = box_corners(ho, wo)
    pix = torch.full((len(corners), M_TILE), -1, dtype=torch.int64)
    for t, (oy0, ox0) in enumerate(corners):
        for r in range(M_TILE):
            ly, lx = box_row_pixel(r, bx)
            oy, ox = oy0 + ly, ox0 + lx
            if ly < by and oy < ho and ox < wo:
                pix[t, r] = oy * wo + ox
    return pix


def box_acc(xq: torch.Tensor, qc: kq.QuantConv) -> torch.Tensor:
    """(B, tiles, M_TILE, R) accumulators of the box tiles, as the kernel
    sums them: per tap and slab one TMA box of A, landed as rows ly bx + lx
    (slabs of 64 channels for Cp <= 64, else 128)."""
    b, hp, wp, cp = xq.shape
    sub = qc.phases == 4
    ho, wo = (hp - 1, wp - 1) if sub else ((hp - 3) // 2 + 1, (wp - 3) // 2 + 1)
    bx, by = box_tile(ho, wo)
    slab = 64 if cp <= 64 else K_SLAB
    view = (xq.reshape(b * hp, wp, cp) if sub else xq.reshape(b * hp // 2, 2, wp // 2, 2, cp)).double()
    w = qc.w.double()  # (R, taps, Cp)
    corners = box_corners(ho, wo)
    acc = torch.zeros((b, len(corners), M_TILE, w.shape[0]), dtype=torch.float64)
    for i in range(b):
        for t, (oy0, ox0) in enumerate(corners):
            for tap in range(qc.kh * qc.kw):
                ky, kx = divmod(tap, qc.kw)
                for c0 in range(0, cp, slab):
                    if sub:
                        a = tma_box(view, (i * hp + oy0 + ky, ox0 + kx, c0), (by, bx, slab))
                    else:
                        a = tma_box(view, (i * hp // 2 + oy0 + ky // 2, ky & 1, ox0 + kx // 2,
                                           kx & 1, c0), (by, 1, bx, 1, slab))
                    # past Cp both operands are zeros (the weights' box too)
                    wt = F.pad(w[:, tap, c0:c0 + slab], (0, c0 + slab - min(cp, c0 + slab)))
                    acc[i, t, :by * bx] += a.reshape(by * bx, slab) @ wt.T
    return acc.to(torch.int64)


def box_store(acc: torch.Tensor, qc: kq.QuantConv, ho: int, wo: int) -> torch.Tensor:
    """The epilogue's stores of the box accumulators -> y (integers): per
    launch of ``box_launches`` and N tile of its width kNW (rows past R are
    zeros, as the weights' box reads them), the tile's rows decoded by
    shifts and staged in chunks of ``chunk_rows`` rows as the kernel lays
    them out, each chunk that holds columns inside the box stored at the
    coordinates its box store gives it, clipped at the array's dims."""
    b, _, _, r = acc.shape
    sub = qc.phases == 4
    bx, by = box_tile(ho, wo)
    co_n, plane_h, plane_w = (r // 4, 2 * ho, 2 * wo) if sub else (r, ho, wo)
    acc = F.pad(acc, (0, BOX_NW))  # rows past R: zeros
    y = torch.zeros((b, co_n, plane_h, plane_w), dtype=acc.dtype)
    for t, (oy0, ox0) in enumerate(box_corners(ho, wo)):
        vx = min(bx, wo - ox0)
        for first, ntiles, nw in box_launches(r):
            for n0 in range(first, first + ntiles * nw, nw):
                chunk_rows = (nw // 2 if sub else nw) * by
                chunks = -(-(2 * vx if sub else vx) // 32)
                staged = torch.zeros((b, (2 * bx if sub else bx) // 32 * chunk_rows, 32), dtype=acc.dtype)
                for m in range(M_TILE):
                    ly, lx = box_row_pixel(m, bx)
                    if ly >= by:
                        continue
                    for c in range(nw):
                        if sub:  # c = 4 co + 2 py + px, x = 2 lx + px
                            x, row = 2 * lx + c % 2, (c // 4 * by + ly) * 2 + c // 2 % 2
                        else:
                            x, row = lx, c * by + ly
                        staged[:, x // 32 * chunk_rows + row, x % 32] = acc[:, t, m, n0 + c]
                for j in range(chunks):
                    for row in range(chunk_rows):
                        if sub:
                            co, ly, py = n0 // 4 + row // 2 // by, row // 2 % by, row % 2
                            yy, x0 = 2 * (oy0 + ly) + py, 2 * ox0 + 32 * j
                        else:
                            co, ly = n0 + row // by, row % by
                            yy, x0 = oy0 + ly, ox0 + 32 * j
                        if co < co_n and oy0 + ly < ho and x0 < plane_w:
                            n = min(32, plane_w - x0)
                            y[:, co, yy, x0:x0 + n] = staged[:, j * chunk_rows + row, :n]
    return y


# (B, C, Co, H, W, padding): the down0-like Cp 64 (a 64-channel slab) with 8
# x 16 pixel boxes; Wo > 128 (two 128-column spans per row); Wo = 80 (one
# row of a 128-column box, 80 columns inside); Wo = 5 (boxes of 4 x 32
# pixels, 5 columns inside) with odd B; a 32-channel tail slab (Cp 160); odd
# H and W (the padded input rounded up to an even size), reflect and zero
# padded; R 300 (two 128-row N tiles and a 44-row tail, a launch 64 wide)
S2_CASES = {
    "cp64": (2, 64, 40, 16, 32, "reflect"),
    "wo_above_m_tile": (1, 32, 24, 4, 260, "reflect"),
    "wo_80": (1, 24, 40, 4, 160, "reflect"),
    "wo_5_odd_batch": (3, 40, 24, 60, 10, "reflect"),
    "tail_k_slab": (1, 160, 48, 8, 12, None),
    "odd_h_w": (2, 24, 16, 9, 11, "reflect"),
    "odd_h_w_zero_pad": (1, 24, 16, 7, 5, None),
    "r300": (1, 16, 300, 4, 6, "reflect"),
}


def _s2_case(name, seed):
    b, c, co, h, w, padding = S2_CASES[name]
    rng = np.random.default_rng(seed)
    weight = torch.from_numpy((rng.standard_normal((co, c, 3, 3)) * 0.1).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(co) * 0.2).astype(np.float32))
    qc = kq.quant_conv(weight, bias, 2.5, 2, padding)
    x = torch.from_numpy((rng.standard_normal((b, c, h, w)) * 1.5).astype(np.float32))
    return qc, x


@pytest.mark.parametrize("name", list(S2_CASES))
def test_stride2_boxes_give_the_plain_accumulators(name):
    qc, x = _s2_case(name, len(name))
    b, c, h, w = x.shape
    xq = kq.quant_pad_plain(x, qc)
    hp, wp = kq.padded_size(qc, h, w)
    assert xq.shape == (b, hp, wp, qc.cp) and hp % 2 == 0 and wp % 2 == 0
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    pix = box_pixels(ho, wo)
    acc = box_acc(xq, qc)
    want = kq.conv_acc_plain(xq, qc).to(torch.int64)
    assert want.shape == (b, qc.cout, ho, wo)
    keep = pix >= 0
    got = torch.zeros((b, qc.cout, ho * wo), dtype=torch.int64)
    for i in range(b):
        got[i][:, pix[keep]] = acc[i][keep].T
    assert torch.equal(got.reshape(want.shape), want)
    # every output pixel is some tile's row, once; and the stores put it there
    assert torch.equal(pix[keep].sort().values, torch.arange(ho * wo))
    assert torch.equal(box_store(acc, qc, ho, wo), want)


@pytest.mark.parametrize("name", list(S2_CASES))
def test_stride2_tile_partials_give_the_plain_statistics(name):
    qc, x = _s2_case(name, 20 + len(name))
    b, c, h, w = x.shape
    xq = kq.quant_pad_plain(x, qc)
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    a = box_acc(xq, qc) * (box_pixels(ho, wo) >= 0).to(torch.int64)[None, :, :, None]
    psum, psq = a.sum(2), (a * a).sum(2)
    assert psum.shape == (b, box_tiles(ho, wo), qc.cout)
    got = stats_from_partials(psum, psq, qc, ho * wo)
    want = kq.stats_plain(kq.conv_acc_plain(xq, qc), qc)
    assert all(torch.equal(g, r) for g, r in zip(got, want))


# (B, C, Co, H, W): Cp 64; DecoderConcat's 276 -> 138 (Cp 288: a 32-channel
# tail slab; R 552: four 128-row N tiles and a 40-row tail, a launch 64
# wide) and 146 -> 73 (Cp 160, R 292: two tiles and a 36-row tail); W above
# the 128-column box; W = 80 (one row of a 128-column box, 160 output
# columns inside); odd B with odd H and W
SUB_CASES = {
    "cp64": (2, 64, 32, 6, 8),
    "concat_276_to_138": (1, 276, 138, 3, 4),
    "concat_146_to_73": (1, 146, 73, 4, 5),
    "w_above_box": (1, 16, 8, 2, 140),
    "w_80": (1, 16, 12, 2, 80),
    "odd_batch": (3, 40, 12, 5, 7),
}


def _sub_case(name, seed):
    b, c, co, h, w = SUB_CASES[name]
    rng = np.random.default_rng(seed)
    weight = torch.from_numpy((rng.standard_normal((c, co, 3, 3)) * 0.1).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(co) * 0.2).astype(np.float32))
    qc = kq.quant_deconv(weight, bias, 2.5)
    x = torch.from_numpy((rng.standard_normal((b, c, h, w)) * 1.5).astype(np.float32))
    return weight, qc, x


@pytest.mark.parametrize("name", list(SUB_CASES))
def test_subpixel_boxes_and_phase_rows_give_the_transposed_conv(name):
    """The 2x2 taps' boxes over the end-padded input, stored by phase row,
    equal the int8 transposed conv itself (F.conv_transpose2d of the same
    int8 operands, exact in f64) and the plain version's interleave."""
    weight, qc, x = _sub_case(name, len(name))
    b, c, h, w = x.shape
    xq = kq.quant_pad_plain(x, qc)
    assert xq.shape == (b, h + 1, w + 1, qc.cp)
    acc = box_acc(xq, qc)
    pix, keep = box_pixels(h, w), box_pixels(h, w) >= 0
    rows = torch.zeros((b, 4 * qc.cout, h * w), dtype=torch.int64)
    for i in range(b):
        rows[i][:, pix[keep]] = acc[i][keep].T
    assert torch.equal(rows.reshape(b, -1, h, w), kq.conv_acc_plain(xq, qc).to(torch.int64))
    y = box_store(acc, qc, h, w)
    assert torch.equal(y, kq._interleave(kq.conv_acc_plain(xq, qc), 4).to(torch.int64))
    w_q, _ = kq.quantize_weight(weight, out_dim=1)  # the port's IOHW layout
    ref = F.conv_transpose2d(xq[:, :h, :w, :c].permute(0, 3, 1, 2).double(), w_q.double(),
                             stride=2, padding=1, output_padding=1)
    assert torch.equal(y, ref.to(torch.int64))


@pytest.mark.parametrize("name", list(SUB_CASES))
def test_subpixel_tile_partials_give_the_plain_statistics(name):
    _, qc, x = _sub_case(name, 30 + len(name))
    b, c, h, w = x.shape
    xq = kq.quant_pad_plain(x, qc)
    a = box_acc(xq, qc) * (box_pixels(h, w) >= 0).to(torch.int64)[None, :, :, None]
    psum, psq = a.sum(2), (a * a).sum(2)
    assert psum.shape == (b, box_tiles(h, w), 4 * qc.cout)
    got = stats_from_partials(psum, psq, qc, h * w)
    want = kq.stats_plain(kq.conv_acc_plain(xq, qc), qc)
    assert all(torch.equal(g, r) for g, r in zip(got, want))


def test_the_phase_rows_keep_a_channel_together():
    """Rows 4 co + 2 py + px: every N tile of every launch (each starts at a
    multiple of 4, the tail too) holds all four phases of each channel it
    touches, at DecoderConcat's widths too."""
    for co in (64, 128, 138, 73):
        rows = sorted(kq.phase_row(py, c, px) for py in (0, 1) for c in range(co) for px in (0, 1))
        assert rows == list(range(4 * co))
        starts = [n0 for first, tiles, nw in box_launches(4 * co)
                  for n0 in range(first, first + tiles * nw, nw)]
        assert all(n0 % 4 == 0 for n0 in starts)
        for c in range(co):
            tile = {max(n for n in starts if n <= kq.phase_row(py, c, px))
                    for py in (0, 1) for px in (0, 1)}
            assert len(tile) == 1

