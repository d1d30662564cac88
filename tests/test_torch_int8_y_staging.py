"""The byte layout in which ``conv_box_kernel`` (``csrc/int8_conv.cu``: the
stride-2 conv of kernel 7 and the transposed conv of kernel 5) stages y for
its TMA box stores, emulated on the CPU in both of y's types.

The kernel writes y, dequantized from the accumulators, over its ring in
chunks of 32 output columns: ``chunk_rows`` rows of 32 elements, 128 bytes
of f32 or 64 of bf16, which a store reads as one box with TMA's swizzle of
that width (128-byte, or 64-byte). The box element at row ``row`` and
column ``x`` of a chunk lies at logical byte ``row * row_bytes + x * esize``
of it, and TMA moves its 16-byte unit by XOR with address bits [7:10) (128)
or [7:9) (64), the hardware's pattern, written here apart from the kernel's
``swizzled()``. Each thread of the two consumer warpgroups holds the
accumulators of rows ``16 warp + lane / 4 + 8 h`` (of its warpgroup's 64)
and columns ``8 j + 2 (lane % 4) + e`` (the wgmma layout); the emulation
walks the kernel's loops as written and checks that every value lands where
the store's box expects it, once. ``tests/test_torch_int8_tiling.py`` holds
the staged rows' place in y; ``tests/test_torch_int8_bf16_store_gpu.py`` the
stores themselves on the card. No card and no JAX are needed.
"""
import itertools

import pytest

M_TILE = 128


def tma_swizzle(offset: int, row_bytes: int) -> int:
    """TMA's swizzle of a ``row_bytes``-wide box (128 or 64) at ``offset``
    from a 1024-byte-aligned base: the 16-byte unit bits [4, 4 + u) XOR
    address bits [7, 7 + u), u = log2(row_bytes / 16)."""
    units = row_bytes // 16
    return offset ^ (((offset >> 7) & (units - 1)) << 4)


def kernel_swizzled(row: int, x: int, esize: int) -> int:
    """``swizzled<T>(row, x)`` of the kernel, as written there."""
    k_row = 32 * esize
    byte = x * esize
    return row * k_row + (((byte >> 4) ^ ((row * k_row >> 7) & (k_row // 16 - 1))) << 4) + (byte & 15)


def box_tiles():
    """(bx, by) of every box tile the library forms: bx = 32, 64 or 128, by =
    min(128 / bx, Ho), Ho from 1 up."""
    return sorted({(bx, min(M_TILE // bx, ho)) for bx in (32, 64, 128) for ho in (1, 2, 3, 4, 9)})


def staged_writes(sub: bool, esize: int, nw: int, bx: int, by: int):
    """(byte offset, N-tile column c, box pixel (ly, lx), px) of each value
    the epilogue's step 3 writes, walking its loops as the kernel does."""
    k_row = 32 * esize
    chunk_rows = (nw // 2 if sub else nw) * by
    lg = {128: 7, 64: 6, 32: 5}[bx]
    out = []
    for wg, warp, lane, h in itertools.product(range(2), range(4), range(32), range(2)):
        r = wg * 64 + warp * 16 + lane // 4 + 8 * h
        ly, lx = r >> lg, r & (bx - 1)
        if ly >= by:
            continue
        q4 = lane % 4
        for e in range(1 if sub else 2):
            x = 2 * lx if sub else lx
            row0 = (((q4 >> 1) * by + ly) << 1) + (q4 & 1) if sub else (2 * q4 + e) * by + ly
            step = 4 * by if sub else 8 * by
            at = (x >> 5) * chunk_rows * k_row
            o0 = kernel_swizzled(row0, x & 31, esize)
            o1 = kernel_swizzled(row0 + step, x & 31, esize) - step * k_row
            for j in range(nw // 8):
                c = 8 * j + 2 * q4 + e
                to = at + j * step * k_row + (o1 if j & 1 else o0)
                if sub:  # columns c and c + 1: px 0 and 1, side by side
                    out.append((to, c, (ly, lx), 0))
                    out.append((to + esize, c + 1, (ly, lx), 1))
                else:
                    out.append((to, c, (ly, lx), 0))
    return out, chunk_rows


@pytest.mark.parametrize("sub", [False, True], ids=["stride2", "transposed"])
@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("nw", [128, 64, 32])
def test_staged_y_is_the_store_boxes_layout(sub, esize, nw):
    k_row = 32 * esize
    for bx, by in box_tiles():
        writes, chunk_rows = staged_writes(sub, esize, nw, bx, by)
        # every chunk starts on a boundary of the swizzle's repeat (1024
        # bytes for 128-byte rows, 512 for 64), as TMA reads the pattern
        # off the address
        assert chunk_rows * k_row % (8 * k_row) == 0
        seen = set()
        for to, c, (ly, lx), px in writes:
            # where the chunk's box store reads column c at box pixel (ly,
            # lx): stride 2, row c by + ly at x = lx; transposed (c = 4 co
            # + 2 py + px), row (co by + ly) 2 + py at x = 2 lx + px
            if sub:
                co, py = c // 4, c // 2 % 2
                assert px == c % 2
                row, x = (co * by + ly) * 2 + py, 2 * lx + px
            else:
                row, x = c * by + ly, lx
            chunk = x // 32
            want = chunk * chunk_rows * k_row + tma_swizzle(row * k_row + (x % 32) * esize, k_row)
            assert to == want, (bx, by, c, ly, lx)
            assert to % esize == 0 and to not in seen
            seen.add(to)
        # one value for each (column, pixel) of the box
        assert len(seen) == nw * bx * by


@pytest.mark.parametrize("esize", [4, 2], ids=["f32", "bf16"])
def test_thread_stores_read_the_staged_layout(esize):
    """The route for rows TMA cannot take (a warp per staged row, lane x)
    reads ``swizzled<T>(row, lane)``: the same bytes as the box layout."""
    k_row = 32 * esize
    for row, lane in itertools.product(range(512), range(32)):
        assert kernel_swizzled(row, lane, esize) == tma_swizzle(row * k_row + lane * esize, k_row)


@pytest.mark.parametrize("mtiles,ntiles", [(1, 1), (7, 1), (33, 2), (256, 4), (5, 3)])
@pytest.mark.parametrize("order", ["kernel", "grid_m_fastest"])
def test_the_grid_covers_every_tile_pair_once(mtiles, ntiles, order):
    """The 1-D grid of mtiles x ntiles blocks decoded as the kernel does (an
    M tile's N tiles as consecutive blocks), and as the ``grid_m_fastest``
    knob of ``scripts/int8_conv_knobs.py`` does: every (M tile, N tile)
    once."""
    grid = mtiles * ntiles
    pairs = []
    for bid in range(grid):
        if order == "kernel":
            mt, nt = bid // ntiles, bid % ntiles
        else:
            mt, nt = bid % (grid // ntiles), bid // (grid // ntiles)
        pairs.append((mt, nt))
    assert sorted(pairs) == sorted(itertools.product(range(mtiles), range(ntiles)))
    if order == "kernel":
        assert all(mt == i // ntiles for i, (mt, _) in enumerate(pairs))
