"""The yardstick of the kernels: each hand-written kernel function's
operations and bytes, counted from its call's shapes, and the H100's peaks.

A kernel *function* is counted, not the launches that implement it: every
input it is given is read once and every output it returns is written once,
and nothing that an implementation keeps between its own launches (a padded
int8 copy of the input, a conv's h1 inside a resblock) is counted. So the
roofline share reads the same work whatever implements the function, and a
change that fuses launches moves the measured time, not the count.

Operations are counted per precision of the unit that computes them:
``int8`` (int8 tensor-core multiply-adds, 2 per MAC), ``bf16`` (bf16
tensor-core multiply-adds) and ``f32`` (f32 arithmetic outside the tensor
cores: the elementwise prologues, norms and epilogues, a few per element).
A kernel's least time is the larger of sum(ops / peak) over precisions and
bytes over the memory bandwidth.

Each function takes the call's positional and keyword arguments and its
result, and reads only shapes, dtypes and the fields of a ``QuantConv``.
"""
from __future__ import annotations

# NVIDIA H100 SXM, published dense rates (no sparsity), at the full 700 W limit
PEAKS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def nbytes(t) -> int:
    return 0 if t is None else int(t.numel()) * int(t.element_size())


def numel(t) -> int:
    return 0 if t is None else int(t.numel())


def least_seconds(ops: dict, nbytes_: int) -> float:
    """The least time one H100 needs: the slower of compute and memory."""
    compute = sum(n / PEAKS[p] for p, n in ops.items())
    return max(compute, nbytes_ / HBM_BYTES_PER_S)


def _arg(args, kwargs, i: int, name: str, default=None):
    if len(args) > i:
        return args[i]
    return kwargs.get(name, default)


def _pending_bytes(pending) -> int:
    """A deferred norm's per-(sample, channel) scale and shift, f32."""
    return 0 if pending is None else nbytes(pending["scale"]) + nbytes(pending["shift"])


def landing_taps(size: int, k: int, s: int, p: int, out: int) -> int:
    """Pairs (input index, tap) of a transposed conv along one axis whose
    output index s i - p + t lies in [0, out)."""
    return sum(1 for i in range(size) for t in range(k) if 0 <= s * i - p + t < out)


def moments(args, kwargs, out) -> dict:
    """Kernel 1: per-(sample, channel) sum and sum of squares of x."""
    x = args[0]
    return {"ops": {"f32": 3 * numel(x)}, "bytes": nbytes(x) + sum(nbytes(t) for t in out)}


def adain(args, kwargs, out) -> dict:
    """Kernel 3: (1 + gamma) IN(x) + beta, statistics and apply in one function."""
    x, gamma, beta = args[:3]
    return {"ops": {"f32": 6 * numel(x)},
            "bytes": nbytes(x) + nbytes(gamma) + nbytes(beta) + nbytes(out)}


def _quant_weight_bytes(qc) -> int:
    """The function's int8 weights (C_out x C_in x 3 x 3, whatever layout
    the kernel keeps them in), its f32 per-channel scales and bias, and the
    activation scale."""
    rows = qc.cout
    return (qc.cout * qc.cin * 9 + 4 * rows + (4 * rows if qc.bias is not None else 0) + 4)


def int8_conv(args, kwargs, out) -> dict:
    """Kernels 4, 7 and 5: a 3x3 pad-1 conv at stride 1 or 2, or the
    k3/s2/p1/op1 transposed conv, in int8, with an optional deferred-norm
    prologue on its input and statistics of its output."""
    x, qc = args[0], args[1]
    pending = _arg(args, kwargs, 2, "pending")
    y, stats = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
    b, _, h, w = x.shape
    ho, wo = y.shape[2], y.shape[3]
    if qc.phases == 4:  # transposed: the taps that land in the output
        macs = b * qc.cin * qc.cout * landing_taps(h, 3, 2, 1, ho) * landing_taps(w, 3, 2, 1, wo)
    else:
        macs = b * qc.cout * ho * wo * qc.cin * 9
    f32 = numel(x) * (4 if pending is not None else 1) + 2 * numel(y) + (3 * numel(y) if stats else 0)
    byts = (nbytes(x) + _pending_bytes(pending) + _quant_weight_bytes(qc) + nbytes(y)
            + sum(nbytes(t) for t in stats))
    return {"ops": {"int8": 2 * macs, "f32": f32}, "bytes": byts}


def int8_resblock(args, kwargs, out) -> dict:
    """Kernel 6: x + norm(conv2(relu(norm(conv1(x))))) with int8 convs."""
    x, q1, q2, gamma, beta = args[:5]
    b, c, h, w = x.shape
    macs = 2 * b * c * h * w * c * 9
    byts = (nbytes(x) + _quant_weight_bytes(q1) + _quant_weight_bytes(q2) + nbytes(gamma)
            + nbytes(beta) + nbytes(out))
    return {"ops": {"int8": 2 * macs, "f32": 12 * numel(x)}, "bytes": byts}


def head(args, kwargs, out) -> dict:
    """Kernel 8: the deferred LayerNorm and relu, a 1x1 conv to Co, tanh."""
    x, pending, weight = args[:3]
    bias = _arg(args, kwargs, 3, "bias")
    b, c, h, w = x.shape
    co = weight.shape[1]
    ops = 2 * b * h * w * c * co + 3 * numel(x) + numel(out)
    byts = nbytes(x) + _pending_bytes(pending) + nbytes(weight) + nbytes(bias) + nbytes(out)
    return {"ops": {"f32": ops}, "bytes": byts}


def _conv_prec(x) -> str:
    return "bf16" if str(x.dtype) == "torch.bfloat16" else "f32"


def resblock_fwd(args, kwargs, out) -> dict:
    """Kernel 9: the training resblock's forward; it returns y and, for the
    backward, h1, h2 and the norms' statistics."""
    x, w1, w2, gamma, beta = args[:5]
    b, c, h, w = x.shape
    macs = 2 * b * c * h * w * c * 9
    byts = (nbytes(x) + nbytes(w1) + nbytes(w2) + nbytes(gamma) + nbytes(beta)
            + sum(nbytes(t) for t in out))
    return {"ops": {_conv_prec(x): 2 * macs, "f32": 12 * numel(x)}, "bytes": byts}


def resblock_bwd(args, kwargs, out) -> dict:
    """Kernel 10: the training resblock's backward, the data and weight
    gradients of both convs and the norms' gradients."""
    x, h1, h2, g, stats, w1, w2, gamma, beta = args[:9]
    b, c, h, w = x.shape
    macs = 4 * b * c * h * w * c * 9  # dgrad and wgrad of each conv
    byts = (sum(nbytes(t) for t in (x, h1, h2, g, stats, w1, w2, gamma, beta))
            + sum(nbytes(t) for t in out))
    return {"ops": {_conv_prec(x): 2 * macs, "f32": 24 * numel(x)}, "bytes": byts}
