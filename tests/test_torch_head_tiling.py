"""The int8 head's tiling (``ops/kernels/head.py`` ``head_tiling``) on the
CPU: the index math of ``csrc/head.cu`` emulated in numpy, so that a grid
that misses or repeats a pixel shows here, where the kernel cannot run; and
the wrapper's checks of what the kernel cannot take, which raise before any
launch; and the plain version's per-image term, against the same conv over
the term's channels concatenated. Needs no JAX and no card.

The grid is (blocks_per_sample, B); thread t of block (bx, b) takes run
r = bx * THREADS + t of sample b if r < runs. A vector run r covers pixels
r E .. r E + E - 1; a scalar run r of warp group g = r // 32 and lane
l = r % 32 covers pixels 32 E g + l + 32 i (i < E). Pixels at or past hw are
neither loaded nor stored. Every plane (b, c) of x and (b, o) of the output
is offset by a multiple of hw, so covering one plane covers them all.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels.int8_conv import Pending

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the serving paths' shapes: AdaINModel / BaseModel A int8 at B=8, the
# bf16 forward at B=64, the sample CLI's 540x960 at B=4
TABLE = [(8, 256 * 256, "bf16"), (64, 256 * 256, "bf16"), (4, 540 * 960, "bf16"),
         (8, 256 * 256, "f32")]
RAGGED_HW = [1, 7, 9, 37 * 53, 37 * 56, 540 * 960]
RAGGED_B = [1, 3, 64]


def run_pixels(t: khead.HeadTiling, r: np.ndarray) -> np.ndarray:
    """(len(r), elems) pixels of runs r, as csrc/head.cu maps them."""
    e = np.arange(t.elems)
    if t.vector:
        return r[:, None] * t.elems + e
    return (r - r % khead.WARP)[:, None] * t.elems + e * khead.WARP + (r % khead.WARP)[:, None]


def coverage(hw: int, dtype: torch.dtype, aligned: bool = True):
    """How often each pixel of a plane is loaded and stored over the grid's
    blocks of one sample, and the tiling."""
    t = khead.head_tiling(hw, dtype, aligned)
    assert t.runs % khead.WARP == 0 and t.runs * t.elems >= hw
    # every block holds at least one live run, and the grid holds every run
    assert (t.blocks_per_sample - 1) * khead.THREADS < t.runs <= t.blocks_per_sample * khead.THREADS
    r = np.arange(t.blocks_per_sample * khead.THREADS)  # block bx, thread t: bx * THREADS + t
    px = run_pixels(t, r[r < t.runs]).ravel()
    return np.bincount(px[px < hw], minlength=hw), t


@pytest.mark.parametrize("b,hw,dtype_name", TABLE)
def test_tiling_covers_the_serving_shapes(b, hw, dtype_name):
    """Every serving shape takes 16-byte runs, each pixel once."""
    counts, t = coverage(hw, DTYPES[dtype_name])
    assert t.vector and (counts == 1).all()
    assert b * t.blocks_per_sample >= 132  # a block for every SM of an H100, or more


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("hw", RAGGED_HW)
@pytest.mark.parametrize("b", RAGGED_B)
def test_tiling_covers_ragged_shapes(b, hw, dtype_name):
    """Vector runs where hw is a multiple of the vector, else scalar runs;
    either way every pixel once, the last warp group cut at hw (B is the
    grid's second dimension: each sample's blocks cover its plane alike)."""
    dtype = DTYPES[dtype_name]
    counts, t = coverage(hw, dtype)
    assert t.vector == (hw % (16 // dtype.itemsize) == 0)
    assert (counts == 1).all()
    if b * hw <= 2**20:  # the whole (B, C) input, as each block offsets its sample and planes
        c = 3
        r = np.arange(t.blocks_per_sample * khead.THREADS)
        px = run_pixels(t, r[r < t.runs]).ravel()
        px = px[px < hw]
        flat = (np.arange(b)[:, None, None] * c * hw + np.arange(c)[None, :, None] * hw
                + px[None, None, :]).ravel()
        assert (np.bincount(flat, minlength=b * c * hw) == 1).all()


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_misaligned_x_takes_scalar_runs(dtype_name):
    """x off a 16-byte boundary takes the scalar runs at any hw."""
    counts, t = coverage(256 * 256, DTYPES[dtype_name], aligned=False)
    assert not t.vector and (counts == 1).all()


def test_vector_runs_are_16_byte_aligned_in_every_plane():
    """A vector run's first pixel starts a 16-byte vector in every (b, c)
    plane: plane offsets are multiples of hw, which the vector divides."""
    for hw in (256 * 256, 540 * 960, 37 * 56):
        for dtype in DTYPES.values():
            t = khead.head_tiling(hw, dtype)
            first = run_pixels(t, np.arange(t.runs))[:, 0]
            planes = np.arange(3 * 5)[:, None] * hw
            assert ((planes + first[None, :]) * dtype.itemsize % 16 == 0).all()


def _args(b=2, c=6, h=5, w=7, co=3, dtype=torch.float32):
    x = torch.zeros((b, c, h, w), dtype=dtype)
    pending = Pending(torch.ones(b, c), torch.zeros(b, c), True, 0.0)
    return x, pending, torch.ones(co, c), torch.zeros(co)


@pytest.mark.parametrize("case", ["co9", "f16", "f64", "strided", "scale_shape", "shift_dtype",
                                  "weight_shape", "bias_shape", "scale_device", "grid",
                                  "t_shape", "t_dtype", "t_strided", "t_device"])
def test_wrapper_raises_before_any_launch(case):
    """The checks the wrapper makes on a CUDA tensor before it computes a
    tiling or launches, here on CPU tensors (a meta tensor for the device
    check)."""
    x, pending, weight, bias = _args()
    t = None
    if case == "co9":
        x, pending, weight, bias = _args(co=9)
    elif case in ("f16", "f64"):
        x = x.to(torch.float16 if case == "f16" else torch.float64)
    elif case == "strided":
        x = torch.zeros((2, 7, 5, 6)).transpose(1, 3)
    elif case == "scale_shape":
        pending = replace(pending, scale=torch.ones(2, 5))
    elif case == "shift_dtype":
        pending = replace(pending, shift=pending.shift.double())
    elif case == "weight_shape":
        weight = torch.ones(3, 5)
    elif case == "bias_shape":
        bias = torch.zeros(4)
    elif case == "scale_device":
        pending = replace(pending, scale=pending.scale.to("meta"))
    elif case == "grid":
        x, pending, weight, bias = _args(b=2**16, c=1, h=1, w=1)
    elif case == "t_shape":
        t = torch.zeros(3, 2)
    elif case == "t_dtype":
        t = torch.zeros(2, 3, dtype=torch.bfloat16)
    elif case == "t_strided":
        t = torch.zeros(3, 2).t()
    elif case == "t_device":
        t = torch.zeros(2, 3, device="meta")
    before = khead.head.launches
    with pytest.raises(ValueError):
        khead._checked(x, pending, weight, bias, t)
    assert khead.head.launches == before


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_wrapper_takes_what_the_kernel_takes(dtype_name):
    """The checks pass what the kernel takes: f32 weights and bias as given
    (the kernel rounds them to bf16 values for a bf16 x), with no copy of
    an f32 weight."""
    x, pending, weight, bias = _args(co=8, dtype=DTYPES[dtype_name])
    weight = weight * 1.001
    w, b = khead._checked(x, pending, weight, bias.bfloat16())
    assert w.data_ptr() == weight.data_ptr()
    assert b.dtype == torch.float32 and b.shape == (8,)


def test_wrapper_refuses_other_devices():
    x, pending, weight, bias = _args()
    before = khead.head.launches
    with pytest.raises(ValueError, match="CPU or CUDA"):
        khead.head(x.to("meta"), pending, weight, bias)
    assert khead.head.launches == before


def _seeded(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("b,c,latent,h,w,co", [(2, 13, 4, 6, 5, 3), (3, 9, 8, 4, 7, 5)])
def test_plain_term_is_the_conv_over_the_concatenated_channels(dtype_name, b, c, latent, h, w,
                                                               co):
    """head_plain with t = z W_z^T equals head_plain without a term on [relu
    of the affine of x, z's planes] with the whole (Co, C + latent) weight
    and an identity affine: f32 within 1e-5, bf16 within BF16_TOL (the sums
    over the channels run in other orders). z and W_z are rounded as the
    concat and the bf16 conv round them."""
    dtype = DTYPES[dtype_name]
    gen = torch.Generator().manual_seed(b * 100 + c)
    x = _seeded((b, c, h, w), gen).to(dtype)
    pending = Pending(_seeded((b, c), gen).abs() + 0.5, _seeded((b, c), gen, 0.3), True, 0.0)
    weight = _seeded((co, c + latent), gen, 0.3)
    z = _seeded((b, latent), gen)
    t = z.to(dtype).float() @ weight[:, c:].to(dtype).float().t()
    got = khead.head_plain(x, pending, weight[:, :c], None, "tanh", t)
    h_in = torch.relu(x.float() * pending.scale[:, :, None, None]
                      + pending.shift[:, :, None, None]).to(dtype)
    cat = torch.cat([h_in, z[:, :, None, None].expand(b, latent, h, w).to(dtype)], dim=1)
    identity = Pending(torch.ones(b, c + latent), torch.zeros(b, c + latent), False, 0.0)
    want = khead.head_plain(cat, identity, weight, None, "tanh")
    assert got.dtype == dtype and got.shape == (b, co, h, w)
    tol = 1e-5 if dtype == torch.float32 else khead.BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    # a zero term adds nothing
    assert torch.equal(khead.head_plain(x, pending, weight[:, :c], None, "tanh"),
                       khead.head_plain(x, pending, weight[:, :c], None, "tanh",
                                        torch.zeros(b, co)))
