"""The serving kernels as ``torch.library`` ops, so that a tracer sees them.

``torch.export`` cannot trace into a ``ctypes`` launch. Each serving kernel
is therefore an op of the namespace ``masterthesis_tpu_torch``, defined with
the low-level ``torch.library.Library`` API:

- ``moments`` (kernel 1, ``ops/kernels/moments.py``), ``adain`` (kernel 3,
  ``adain.py``);
- ``int8_conv3x3`` (kernel 4), ``int8_downconv`` (7), ``int8_deconv`` (5)
  and ``int8_resblock`` (6's seven launches), ``int8_conv.py``;
- ``head`` (kernel 8, ``head.py``);
- ``dec_mix`` (BaseModel's decoder mix, ``dec_mix.py``; no Pallas kernel).

Each op has a CUDA implementation (the kernel module's launch on
``torch.cuda.current_stream``, which counts the launch), a CPU
implementation (its plain version, which the tests run) and a fake one
(the output shapes and dtypes, for the tracer). The kernel modules
register their ops when they are imported (:func:`register`), and the
public wrappers (``moments.moments``, ``int8_conv.conv3x3``, ...) run them
through :func:`call`: a plain CUDA tensor outside any tracer goes straight
to the CUDA implementation, every other call (a CPU tensor, a tracer's
fake or functional tensor, an active dispatch mode, ``torch.compile``)
through the op. The dispatcher boxes every argument and calls back into
Python, which on the card's host made the int8 forward, a host-bound path
of 14 op calls, slower than without the ops (``scripts/port_serve_ab.py``
against a checkout without them). Importing this module imports the
kernel modules, so a program that loads an exported bundle needs torch and
this module only.

A ``QuantConv`` is a dataclass, which an op cannot take: the wrappers pass
its tensors and flags instead (see ``int8_conv.py``). Tests substitute
counting functions in :data:`CALLS`.
"""
from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "masterthesis_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")

# name -> the op's default overload
OPS: dict[str, torch._ops.OpOverload] = {}
# what the wrappers call through the dispatcher, by op name: the op
CALLS: dict[str, Callable] = {}
# name -> the op's CUDA implementation, which :func:`call` runs directly
EAGER: dict[str, Callable] = {}


def register(name: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable) -> None:
    """Define ``masterthesis_tpu_torch::<name><schema>`` with its CPU, CUDA
    and fake implementations, and route :data:`CALLS` ``[name]`` to it."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    OPS[name] = getattr(getattr(torch.ops, NAMESPACE), name).default
    CALLS[name] = OPS[name]
    EAGER[name] = cuda


def call(name: str, x: torch.Tensor, *args):
    """Run the op ``name`` on ``x`` and ``args``, as its schema takes them:
    its CUDA implementation directly when ``x`` is a plain CUDA tensor and
    nothing traces, else the op (:data:`CALLS`)."""
    if (type(x) is torch.Tensor and x.is_cuda and not torch._C._len_torch_dispatch_stack()
            and not torch.compiler.is_compiling()):
        return EAGER[name](x, *args)
    return CALLS[name](x, *args)


# the kernel modules register their ops at import
from masterthesis_tpu_torch.ops.kernels import adain, dec_mix, head, int8_conv, moments  # noqa: E402,E501,F401
