"""``--use_dropout`` in training, the port against the JAX package, on the CPU.

Neither package can replay the other's random streams, so dropout is held
in two layers:

1. Blocks. The Flax block runs with ``deterministic=False`` and a fixed
   ``dropout`` rng; its mask is recovered from its own output (``out - x``
   is 0 or 2h, h the deterministic branch, recovered in f32: the mask
   depends on the rng and the shape only) and handed to the port's block.
   Outputs agree within the block tests' tolerances
   (tests/test_torch_blocks.py: f32 1e-4; bf16 5e-2 absolute and 2e-2
   relative); input gradients, relative to their largest entry, in f32
   within 1e-4, in bf16 with at most 5 % of the entries beyond the bf16
   tolerance and the difference within 10 % of the norm (a relu input
   within a bf16 rounding of 0 may decide differently in the two packages).
2. The step. With ``--use_dropout`` and no draws the port's step is JAX's
   deterministic step, routing included: the dropout blocks (``dec1_*``)
   compose, ``dec_share`` and the encoder take kernels 9/10, as often as
   a trace of the JAX package's fused step calls them (config B, the setup
   and tolerances of tests/test_torch_base_train_a.py).

With a generator the step draws one set of keep masks per decode, one per
dropout block, of that block's output shape (``StepDraws.masks``).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

unfreeze = pytest.importorskip("flax.core").unfreeze

from masterthesis_tpu.models import blocks as jb  # noqa: E402
from masterthesis_tpu_torch.models import BaseModel  # noqa: E402
from masterthesis_tpu_torch.models import blocks as tb  # noqa: E402
from masterthesis_tpu_torch.models.translation import StepDraws  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import params_from_jax  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
SHAPE = (2, 8, 8, 16)  # NHWC
# (Flax block, the port's block, style width or None)
BLOCKS = {
    "ResnetBlock": (lambda dt: jb.ResnetBlock(16, dropout=True, dtype=dt),
                    lambda dt: tb.ResnetBlock(16, dropout=True, dtype=dt), None),
    "AdaINResnetBlock": (lambda dt: jb.AdaINResnetBlock(16, dropout=True, dtype=dt),
                         lambda dt: tb.AdaINResnetBlock(16, 6, dropout=True, dtype=dt), 6),
    "DecResnetBlock": (lambda dt: jb.DecResnetBlock(16, dropout=True, dtype=dt),
                       lambda dt: tb.DecResnetBlock(16, 16, dropout=True, dtype=dt), 16),
}


def _flax_run(jmod, params, x, z, dtype, deterministic, g):
    """(out, d out/d x at g) of the Flax block, f32 numpy, NHWC."""
    rngs = None if deterministic else {"dropout": jax.random.PRNGKey(7)}

    def f(xx):
        args = (xx,) if z is None else (xx, jnp.asarray(z, dtype))
        return jmod.apply({"params": params}, *args, deterministic=deterministic, rngs=rngs)

    out, vjp = jax.vjp(f, jnp.asarray(x, dtype))
    (dx,) = vjp(jnp.asarray(g, out.dtype))
    return np.asarray(out.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_dropout_matches_flax(block, dtype):
    make_j, make_t, style = BLOCKS[block]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    z = None if style is None else rng.standard_normal((SHAPE[0], style)).astype(np.float32)
    g = rng.standard_normal(SHAPE).astype(np.float32)
    j32 = make_j(jnp.float32)
    init_args = (jnp.asarray(x),) if z is None else (jnp.asarray(x), jnp.asarray(z))
    params = unfreeze(j32.init(jax.random.PRNGKey(1), *init_args))["params"]

    # the mask, from the f32 block's output: out - x is 2h where kept, else 0
    kept, _ = _flax_run(j32, params, x, z, jnp.float32, False, g)
    det, _ = _flax_run(j32, params, x, z, jnp.float32, True, g)
    h = det - x
    mask = np.abs(kept - x - 2 * h) <= np.abs(kept - x)
    np.testing.assert_allclose(kept, x + np.where(mask, 2 * h, 0.0), atol=1e-5)
    # where h is 0 (DecResnetBlock's last relu) either choice is the same
    assert 0.4 < mask[h != 0].mean() < 0.6, mask[h != 0].mean()

    ref, ref_dx = _flax_run(make_j(JDT[dtype]), params, x, z, JDT[dtype], False, g)
    tmod = make_t(dtype)
    tmod.load_state_dict(params_from_jax({"net": params},
                                         SimpleNamespace(nets={"net": tmod}))["net"])
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    args = () if z is None else (torch.from_numpy(z).to(dtype),)
    out = tmod(xt, *args, mask=torch.from_numpy(mask).permute(0, 3, 1, 2))
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g).to(dtype).permute(0, 3, 1, 2))
    assert out.dtype == dtype
    np.testing.assert_allclose(out.detach().float().permute(0, 2, 3, 1).numpy(), ref, **TOL[dtype])
    dx = dx.float().permute(0, 2, 3, 1).numpy() / np.abs(ref_dx).max()
    ref_dx = ref_dx / np.abs(ref_dx).max()
    if dtype == torch.float32:
        np.testing.assert_allclose(dx, ref_dx, **TOL[dtype])
    else:
        # a relu whose input lies within a bf16 rounding of 0 can decide
        # differently in the two packages, which moves the gradient of its
        # 3 x 3 neighbourhood (all channels, 7 % of the entries here)
        tol = TOL[dtype]
        beyond = np.abs(dx - ref_dx) > tol["atol"] + tol["rtol"] * np.abs(ref_dx)
        assert beyond.mean() <= 0.05, beyond.mean()
        assert np.linalg.norm(dx - ref_dx) <= 0.1 * np.linalg.norm(ref_dx)
    # without a mask the block is its deterministic self
    with torch.no_grad():
        plain = tmod(xt.detach(), *args)
    np.testing.assert_allclose(plain.float().permute(0, 2, 3, 1).numpy(), det, **TOL[dtype])


CONFIGS = {"A": {}, "B": dict(concat=True, reparam=True)}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_step_draws_one_mask_set_per_decode(config):
    """A main step with the model's generator draws the masks of the four
    decodes (the D fakes and G1's first decode at 4B images, G1's cycle and
    G2 at 2B), one per dropout block, bool, of the block's output shape;
    drawn masks are applied (the step's losses move with them)."""
    model = S.port_model("float32", "off", model_cls=BaseModel, use_dropout=True,
                         **CONFIGS[config])
    batch, z_sr, z_sr2 = S.batch_and_draws(0)
    width = {"A": 128, "B": 135}[config]
    blocks = {"A": 4, "B": 3}[config]
    draws = StepDraws(model.generator, z_sr=torch.from_numpy(z_sr), z_sr2=torch.from_numpy(z_sr2))
    logs = model.main_step(batch, draws)
    masks = {k: v for k, v in draws.given.items() if ".drop" in k}
    want = {f"{name}.dec1_{i}": (n, width, 8, 8)
            for name, n in (("d.drop", 8), ("g1.drop", 8), ("g1.drop_rec", 4), ("g2.drop", 4))
            for i in range(blocks)}
    assert {k: tuple(v.shape) for k, v in masks.items()} == want
    assert all(v.dtype == torch.bool for v in masks.values())
    share = torch.cat([v.flatten() for v in masks.values()]).float().mean().item()
    assert 0.45 < share < 0.55, share
    again = S.port_model("float32", "off", model_cls=BaseModel, use_dropout=True,
                         **CONFIGS[config])
    nodrop = {k: v for k, v in draws.given.items() if ".drop" not in k}
    logs_nodrop = again.main_step(batch, StepDraws(**nodrop))
    for k in ("d1_d_adv", "l1_self_rec", "l1_cc_rec", "l1_recon_z"):
        assert float(logs[k]) != float(logs_nodrop[k]), k


def test_deterministic_dropout_step_matches_jax():
    """Config B with ``--use_dropout`` and no draws: JAX's deterministic
    step, routing included. Kernels 9/10 take the encoder and ``dec_share``,
    20 / 15 calls in the port's fused step and in a trace of JAX's fused
    step (the ``dec1_*`` dropout blocks compose); the values are held to
    JAX's composed step, the same function without interpret mode."""
    flags = dict(concat=True, reparam=True, use_dropout=True)
    model = S.port_model("float32", "on", seed=6, model_cls=BaseModel, **flags)
    batch, z_sr, z_sr2 = S.batch_and_draws(6)
    args = dict(S.SHAPE, compute_dtype="float32", **flags)
    jax_calls = S.jax_step_calls(dict(args, fused_resblock="auto"), S.jax_tree(model), batch,
                                 z_sr, z_sr2, BaseModel)
    f0, b0 = krb.resblock_fwd_plain.calls, krb.resblock_bwd_plain.calls
    port = S.run_port(model, batch, z_sr, z_sr2)
    calls = (krb.resblock_fwd_plain.calls - f0, krb.resblock_bwd_plain.calls - b0)
    assert calls == jax_calls == (20, 15)
    ref = S.run_jax(dict(args, fused_resblock="off"), port[2], batch, z_sr, z_sr2, fused=False,
                    model_cls=BaseModel)
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4, min_move=0.1)
