"""G phase 1's gradient per tensor against the JAX package's, at f32.

The whole-step tests (tests/test_torch_train_step*.py) bound the G phases'
gradients per net in norm, because the cycle reconstruction's L1 term is
ill-conditioned in f32 in either package. Here the same G1 loss without that
term, from the same params, batch and styles, is held per tensor: within
1e-3 of each tensor's largest |JAX gradient|, on the fused path (kernels 9
and 10's plain versions against the Pallas kernels in interpret mode) and on
the composed one. A conv bias right before a norm has a gradient of mere
roundoff; its scale is floored at 1e-3 of the net's largest gradient. On this
draw no relu pre-activation lies within roundoff of zero: one that does can
flip its mask between two sum orders and move its layer's gradient by
percents.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_train_args as jax_train_args  # noqa: E402
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel  # noqa: E402
from masterthesis_tpu.ops.pallas import resblock_bf16 as jrb  # noqa: E402
from masterthesis_tpu_torch.models.translation import StepDraws  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_g1_gradient_without_the_cycle_term_matches_jax_per_tensor(fused):
    model = S.port_model("float32", fused, seed=1)
    tree = S.jax_tree(model)
    batch, _, _ = S.batch_and_draws(1)
    img, c_org, b = model._batch(batch)
    with krb.fused_train_trace(fused):
        total, logs = model._g1_loss(img, c_org, b, StepDraws())
        params = [p for n in S.GEN_NETS for p in model.nets[n].parameters()]
        grads = iter(torch.autograd.grad(total - logs["l1_cc_rec"], params))

    jm = JaxAdaINModel(jax_train_args(logdir=None, mode="train", compute_dtype="float32",
                                      fused_resblock="auto" if fused == "on" else "off",
                                      **S.SHAPE))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jimg = jnp.concatenate([batch["x1"], batch["x2"]])
    jc = jnp.concatenate([batch["y1"], batch["y2"]])

    def loss(gp):
        t, g_logs = jm._g1_loss({**jparams, **gp}, {}, jimg, jc, b, None, {}, train=False)
        return t - g_logs["l1_cc_rec"]

    on = fused == "on"
    with S.interpreted_kernels() if on else contextlib.nullcontext(), \
            jrb.fused_train_trace() if on else contextlib.nullcontext():
        jgrads = jax.jit(jax.grad(loss))({n: jparams[n] for n in S.GEN_NETS})
    for net in S.GEN_NETS:
        want = S.to_port(model, net, jax.tree_util.tree_map(np.asarray, jgrads[net]), tree)
        got = {k: next(grads) for k, _ in model.nets[net].named_parameters()}
        floor = 1e-3 * max(w.abs().max().item() for w in want.values())
        for key, w in want.items():
            err = (got[key] - w).abs().max().item()
            assert err <= 1e-3 * max(w.abs().max().item(), floor), (net, key, err)
