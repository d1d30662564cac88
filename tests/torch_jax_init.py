"""The JAX package's model init (``Model.initialize``), each net's init
compiled as one program, for the port's test files whose checks hold the
port against what the JAX package does with weights they both read (a
checkpoint the JAX model saved, a tree converted into both), or hold no
values at all (the trainer's files and log lines).

Eagerly, ``Model.initialize`` runs every Flax init and every conv re-init
op by op: on the CPU its few hundred small XLA compiles take 45-75 s per
file. Inside :func:`compiled_jax_init` each net's ``Module.init`` and each
``init_net`` runs under ``jax.jit`` at XLA's lowest optimization level,
cached by the module's configuration and the inputs' shapes, which takes
15-20 s. The draws are the same threefry streams; a normal init may differ
from the eager one in its last bits (the erf-inverse is compiled another
way), which is why no test that pins the JAX package's own init values
uses it.
"""
from __future__ import annotations

import contextlib

import flax.linen as nn
import jax

from masterthesis_tpu.models import model as jax_model_module

COMPILER_OPTIONS = {"xla_backend_optimization_level": 0,
                    "xla_llvm_disable_expensive_passes": True}
_CACHE: dict = {}


def _shapes(tree) -> str:
    return repr(jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype)) if hasattr(x, "shape") else x, tree))


@contextlib.contextmanager
def compiled_jax_init():
    """``Module.init`` and ``init_net`` of the JAX package compiled, inside
    the block."""
    real_init, real_reinit = nn.Module.init, jax_model_module.init_net

    def init(self, rngs, *args, **kwargs):
        key = ("init", type(self).__qualname__, repr(self), _shapes((rngs, args)), repr(kwargs))
        if key not in _CACHE:
            module = self
            _CACHE[key] = jax.jit(lambda r, a: real_init(module, r, *a, **kwargs),
                                  compiler_options=COMPILER_OPTIONS)
        return _CACHE[key](rngs, args)

    def init_net(params, rng, init_type="normal", init_gain=0.02):
        key = ("init_net", _shapes((params, rng)), init_type, float(init_gain))
        if key not in _CACHE:
            _CACHE[key] = jax.jit(lambda p, r: real_reinit(p, r, init_type, init_gain),
                                  compiler_options=COMPILER_OPTIONS)
        return _CACHE[key](params, rng)

    nn.Module.init, jax_model_module.init_net = init, init_net
    try:
        yield
    finally:
        nn.Module.init, jax_model_module.init_net = real_init, real_reinit


def initialized(model):
    """``model.initialize()`` of a JAX model inside :func:`compiled_jax_init`."""
    with compiled_jax_init():
        return model.initialize()
