"""The decoder-mix op (``ops/kernels/dec_mix.py``) on the CPU: its plain
version against ``DecResnetBlock``'s composed mixes, the block's route to
it, the route's refusals, the op under a tracer, and calibration through
the composed route.

No JAX: the reference is the block's own composed path (instance norm, the
style concat, two 1x1 convs with relu, the residual add).

Tolerances. In f32 the plain version sums the concatenated style channels
apart from the normalized ones, so the two differ by f32 rounding of sums
over 512 terms: 1e-5 of the output's scale. In bf16 the operands are the
same bf16 values and both sum in f32, so a hidden value or a conv's output
can land one bf16 step apart (at most 2^-7 of its value), and with the
residual the sum's rounding one more step: two steps of the larger of the
output and the mix before the residual, on at most 2 % of the outputs.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.models.blocks import DecResnetBlock, concat_label
from masterthesis_tpu_torch.ops import norms, qat
from masterthesis_tpu_torch.ops.kernels import dec_mix as kmix
from masterthesis_tpu_torch.ops.kernels import library

F32_TOL = 1e-5
STEP_TOL = 2.0**-6  # two bf16 steps
MOVED = 0.02


def _randn(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))


def _block(features, style, dtype, seed=0):
    """A block with seeded weights and nonzero biases."""
    blk = DecResnetBlock(features, style, dtype=dtype)
    with torch.no_grad():
        for i, (name, p) in enumerate(sorted(blk.named_parameters())):
            fan_in = p[0].numel() if p.dim() > 1 else 10
            p.copy_(_randn(p.shape, seed + i, fan_in ** -0.5))
    return blk


def _inputs(b, c, s, h, w, dtype, seed=0):
    x = (_randn((b, c, h, w), seed) * _randn((1, c, 1, 1), seed + 1, 0.5, 1.0)
         + _randn((1, c, 1, 1), seed + 2, 0.5)).to(dtype)
    return x, _randn((b, s), seed + 3)


def _composed_mix(a, b, norm, h, z, r=None):
    y = F.relu(b(F.relu(a(concat_label(norm(h), z)))))
    return y if r is None else r + y


def _plain_mix(a, b, norm, h, z, r=None):
    mean, var = norms.moments(h)
    rstd = torch.rsqrt(var + norm.eps)
    ops = kmix.operands(a.weight, a.bias, b.weight, b.bias, z, a.dtype)
    return kmix.dec_mix_plain(h, mean.flatten(1), rstd.flatten(1), *ops, r)


def _assert_bf16_steps(got, want, r=None):
    got, want = got.float(), want.float()
    scale = want.abs() if r is None else torch.maximum(want.abs(), (want - r.float()).abs())
    diff = (got - want).abs()
    assert (diff <= STEP_TOL * scale.clamp_min(1.0)).all(), diff.max()
    assert (diff > 0).float().mean() <= MOVED, (diff > 0).float().mean()


@pytest.fixture
def counted(monkeypatch):
    """The op calls of the block's route, counted through ``library.CALLS``
    (the CPU runs every call through the op)."""
    calls = []
    real = library.CALLS["dec_mix"]
    monkeypatch.setitem(library.CALLS, "dec_mix",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


@pytest.mark.parametrize("residual", [False, True], ids=["mix1", "mix2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_matches_the_composed_mix(dtype, residual):
    """At widths the kernel does not take, too: the plain version is the
    function at any width."""
    for features, style, size, seed in ((256, 256, (5, 7), 0), (24, 40, (6, 4), 9)):
        blk = _block(features, style, dtype, seed)
        x, z = _inputs(2, features, style, *size, dtype, seed)
        h = blk.conv1(x)
        r = x if residual else None
        with torch.no_grad():
            got = _plain_mix(blk.block1_a, blk.block1_b, blk.norm1, h, z, r)
            want = _composed_mix(blk.block1_a, blk.block1_b, blk.norm1, h, z, r)
        assert got.dtype == want.dtype == dtype and got.shape == want.shape
        if dtype == torch.float32:
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL * scale)
        else:
            _assert_bf16_steps(got, want, r)


def test_routed_block_matches_the_composed_block(counted, monkeypatch):
    """bf16 serving at the published widths: two op calls a forward, each
    mix within the bf16 steps of the composed one, and the block's output
    (the second mix with the residual) too."""
    blk = _block(256, 256, torch.bfloat16, 3)
    x, z = _inputs(2, 256, 256, 6, 10, torch.bfloat16, 3)
    with torch.no_grad():
        got = blk(x, z)
        assert len(counted) == 2
        h = blk.conv1(x)
        mix1 = blk._kernel_mix(blk.block1_a, blk.block1_b, blk.norm1, h, z)
        _assert_bf16_steps(mix1, _composed_mix(blk.block1_a, blk.block1_b, blk.norm1, h, z))
        h2 = blk.conv2(mix1)
        mix2 = blk._kernel_mix(blk.block2_a, blk.block2_b, blk.norm2, h2, z, x)
        _assert_bf16_steps(mix2, _composed_mix(blk.block2_a, blk.block2_b, blk.norm2, h2, z, x),
                           x)
        assert torch.equal(got, mix2)
        monkeypatch.setattr(kmix, "takes", lambda *a: False)
        want = blk(x, z)
    assert len(counted) == 4
    assert got.dtype == want.dtype == torch.bfloat16
    # the first mix's steps move the second conv's input: the bound of the
    # bf16 forward (tests/test_torch_int8_bf16.py BF16_FORWARD_TOL)
    assert (got.float() - want.float()).abs().max() <= 5e-2


def _refusals():
    """(name, dtype, context) of each forward that must compose."""
    def calibrating(blk):
        for c in (blk.block1_a, blk.block1_b, blk.block2_a, blk.block2_b):
            c.calib_amax = torch.zeros(())
        return torch.no_grad()

    return [
        ("f32", torch.float32, lambda blk: torch.no_grad()),
        ("requires_grad", torch.bfloat16, lambda blk: torch.enable_grad()),
        # serving's frozen weights, but a style chunk that needs its gradient
        ("style_requires_grad", torch.bfloat16,
         lambda blk: blk.requires_grad_(False) and torch.enable_grad()),
        ("mask", torch.bfloat16, lambda blk: torch.no_grad()),
        ("calibration", torch.bfloat16, calibrating),
        ("qat", torch.bfloat16, lambda blk: qat.qat_trace()),
    ]


@pytest.mark.parametrize("name,dtype,context", _refusals(), ids=lambda v: v if isinstance(v, str)
                         else "")
def test_the_route_refuses(counted, name, dtype, context):
    blk = _block(256, 256, dtype, 4)
    x, z = _inputs(1, 256, 256, 4, 4, dtype, 4)
    mask = torch.ones(x.shape, dtype=torch.bool) if name == "mask" else None
    z.requires_grad_(name == "style_requires_grad")
    before = kmix.dec_mix.launches
    with context(blk):
        if name == "qat":
            with torch.no_grad():
                y = blk(x, z, mask)
        else:
            y = blk(x, z, mask)
    assert counted == [] and kmix.dec_mix.launches == before
    assert y.shape == x.shape and y.dtype == dtype
    if name in ("requires_grad", "style_requires_grad"):
        assert y.requires_grad
    if name == "style_requires_grad":  # the composed route carries z's gradient
        y.float().sum().backward()
        assert z.grad is not None and z.grad.abs().sum() > 0


def test_the_op_refuses_any_input_that_needs_a_gradient():
    """The op has no backward: with grad mode on it raises for a gradient
    needed of any input, the style's vector among them, and runs under
    no_grad."""
    blk = _block(256, 256, torch.bfloat16, 8)
    x, z = _inputs(1, 256, 256, 2, 3, torch.bfloat16, 8)
    a, b = blk.block1_a.requires_grad_(False), blk.block1_b.requires_grad_(False)
    mean, var = norms.moments(x)
    rstd = torch.rsqrt(var + norms.EPS)
    with pytest.raises(RuntimeError, match="no backward"):
        kmix.dec_mix(x, mean.flatten(1), rstd.flatten(1),
                     *kmix.operands(a.weight, a.bias, b.weight, b.bias,
                                    z.requires_grad_(True), a.dtype))
    with torch.no_grad():
        y = kmix.dec_mix(x, mean.flatten(1), rstd.flatten(1),
                         *kmix.operands(a.weight, a.bias, b.weight, b.bias, z, a.dtype))
    assert y.shape == x.shape and not y.requires_grad


def test_the_route_refuses_widths_the_kernel_does_not_take(counted):
    """DecResnetBlock at the CPU tests' small widths keeps composing."""
    assert not kmix.takes(32, 64) and not kmix.takes(256, 576) and kmix.takes(256, 512)
    blk = _block(32, 32, torch.bfloat16, 5)
    x, z = _inputs(1, 32, 32, 4, 4, torch.bfloat16, 5)
    with torch.no_grad():
        blk(x, z)
    assert counted == []


def test_calibration_records_every_mix_conv(counted):
    """While calibrating, the route stays off and each 1x1 conv records the
    amax of its input: the style-concatenated map for ``block*_a``, the
    hidden map for ``block*_b``."""
    blk = _block(256, 256, torch.bfloat16, 6)
    x, z = _inputs(2, 256, 256, 4, 6, torch.bfloat16, 6)
    mixes = (blk.block1_a, blk.block1_b, blk.block2_a, blk.block2_b)
    for c in mixes:
        c.calib_amax = torch.zeros(())
    with torch.no_grad():
        blk(x, z)
    amax = [float(c.calib_amax) for c in mixes]
    for c in mixes:
        c.calib_amax = None
    assert counted == [] and all(a > 0 for a in amax)
    assert amax[0] >= float(z.to(torch.bfloat16).abs().max())  # the style chunk is in a's input


def test_the_op_under_a_tracer():
    """The fake implementation under torch.export: the exported block calls
    the op twice, each with x's shape and dtype, and replays as the eager
    block does."""
    blk = _block(256, 256, torch.bfloat16, 7)
    x, z = _inputs(2, 256, 256, 4, 8, torch.bfloat16, 7)
    with torch.no_grad():
        program = torch.export.export(blk, (x, z), strict=False)
        nodes = [n for n in program.graph.nodes
                 if n.op == "call_function" and n.target == library.OPS["dec_mix"]]
        assert len(nodes) == 2
        for n in nodes:
            assert tuple(n.meta["val"].shape) == tuple(x.shape)
            assert n.meta["val"].dtype == torch.bfloat16
        assert torch.equal(program.module()(x, z), blk(x, z))
