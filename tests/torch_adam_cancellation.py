"""Where the port's BaseModel main step left a parameter unchanged that the
JAX package's step moved, print both packages' Adam moments there.

    python -m tests.torch_adam_cancellation A_fused|A_composed|B_fused

Each case is the setup of one step test in tests/test_torch_base_train_*.py
(weights, batch and styles from the same seeds, the JAX step phase by phase
from the port's params). For every such entry: the parameter, its
gradients in each of the step's phases (before weight decay), m and v after
the net's last update in each package, and the two steps in lr units. ``assert_step_matches``' ``min_move`` rests
on what this shows: the port's m cancels to a value whose step rounds away.
"""
from __future__ import annotations

import sys

import jax
import numpy as np
import torch

from masterthesis_tpu_torch.models import BaseModel
from tests import torch_train_steps as S

jax.config.update("jax_platforms", "cpu")

# name: (flags, port's --fused_resblock, weight seed, batch seed, JAX fused)
CASES = {
    "A_fused": ({}, "on", 0, 0, True),
    "A_composed": ({}, "off", 1, 1, False),
    "B_fused": (dict(concat=True, reparam=True), "on", 0, 0, True),
}


def _jax_adam(states):
    """optax's scale_by_adam state in a chain's state."""
    return next(s for s in states if hasattr(s, "mu"))


def main(case: str) -> None:
    flags, fused, seed, data_seed, jax_fused = CASES[case]
    torch.set_num_threads(4)
    model = S.port_model("float32", fused, seed=seed, model_cls=BaseModel, **flags)
    batch, z_sr, z_sr2 = S.batch_and_draws(data_seed)
    logs, phases, trees = S.run_port(model, batch, z_sr, z_sr2)
    jax_states = []
    real = S.jax_apply_updates

    def capture(tx, g, opt, p, lr):
        new, state = real(tx, g, opt, p, lr)
        jax_states.append(state)
        return new, state

    S.jax_apply_updates = capture
    try:
        args = dict(S.SHAPE, compute_dtype="float32",
                    fused_resblock="auto" if jax_fused else "off", **flags)
        jlogs, jphases, jupdated = S.run_jax(args, trees, batch, z_sr, z_sr2, fused=jax_fused,
                                             model_cls=BaseModel)
    finally:
        S.jax_apply_updates = real
    lr = float(jlogs["lr"])
    like = trees[0]
    # the nets in run_jax's update order: D1, D2, G1's, G2's
    order = ["discriminator1", "discriminator2", *S.GEN_NETS, "content_encoder", "decoder"]
    found = 0
    for i, new in enumerate(jupdated):
        for net, tree in new.items():
            want = S.to_port(model, net, tree, like)
            before = S.to_port(model, net, trees[i][net], like)
            after = S.to_port(model, net, trees[i + 1][net], like)
            keys = [k for k, _ in model.nets[net].named_parameters()]
            state = model.state.opt_state[net]
            jstate = _jax_adam(jax_states[max(k for k, n in enumerate(order) if n == net)])
            jmu = S.to_port(model, net, jax.tree_util.tree_map(np.asarray, jstate.mu), like)
            jnu = S.to_port(model, net, jax.tree_util.tree_map(np.asarray, jstate.nu), like)
            for key, w in want.items():
                p0 = before[key]
                stuck = (after[key] == p0) & ((w - p0).abs() > 0)
                for t in map(tuple, stuck.nonzero().tolist()):
                    found += 1
                    j = keys.index(key)
                    grads = [phases[k][net][key][t].item() for k in range(i) if net in phases[k]]
                    jgrads = [S.to_port(model, net, jphases[k][net], like)[key][t].item()
                              for k in range(i) if net in jphases[k]]
                    grads.append(phases[i][net][key][t].item())
                    jgrads.append(S.to_port(model, net, jphases[i][net], like)[key][t].item())
                    print(f"phase {i} {net} {key} {t}: p {p0[t].item():.9g}\n"
                          f"  port: g {[f'{g:.6g}' for g in grads]} m {state.mu[j][t].item():.6g} "
                          f"v {state.nu[j][t].item():.6g} step 0 lr\n"
                          f"  JAX:  g {[f'{g:.6g}' for g in jgrads]} m {jmu[key][t].item():.6g} "
                          f"v {jnu[key][t].item():.6g} step {(w[t] - p0[t]).item() / lr:.3g} lr")
    print(f"{case}: {found} entries moved by JAX and not by the port")


if __name__ == "__main__":
    main(sys.argv[1])
