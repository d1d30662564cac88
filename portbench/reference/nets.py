"""The plain reference's serving nets, a library: the content encoder, the
style MLP, AdaINModel's and BaseModel A's decoders (AdaIN or DecResnet
blocks, the transposed-conv tail and the tanh head), written out in plain
PyTorch in f32 from the published layer equations, and the arithmetic they
compute in. A configuration's reference is the file
``reference/<reference>.serve.py`` that its ``configs/<config>.json`` names,
which puts these nets together into its ``forward_random``.

It imports nothing of the program and takes no tensor the program made: the
benchmark hands it the seeded weights (one state_dict per net, under the
port's parameter names), the requests and the calibration batches, and it
works out again what the program's set-up derives from them: the amax of
every quantized conv's input over the calibration batches, the
per-output-channel int8 weights and scales.

Arithmetic (:class:`Arith`):

- float: every conv and linear in f32 (TF32 off, see :func:`exact_f32`);
- int ``bits`` (8 for the int8 serving path, 4 for its control): each 3x3
  pad-1 conv (stride 1 and 2) of the content encoder and the decoder, and
  each k3/s2/p1/op1 transposed conv, quantizes its input per tensor,
  ``clip(round(x * q / amax), +-q)`` with q = 2^(bits-1) - 1 and round half
  to even, and its weight per output channel the same way against the
  channel's own amax, sums the integer products and scales back by
  ``(amax / q) * (w_amax_c / q)``, then adds the bias. Every other op (the
  7x7 stem, the 1x1 mix convs and head, the norms, the MLPs) stays f32;
- float with ``cast``: each float conv's and linear's operands go through
  :func:`fp8` first, the control of a bf16 configuration.

With ``tally`` set it also counts the operations of every conv and linear
(2 per multiply-add of the function, a transposed conv's taps that land in
its output only) by the precision the program runs them in, which is what
``mfu.serve`` divides by the peaks; run it on the meta device for that.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from portbench.work import landing_taps

EPS = 1e-5
LRELU = 0.01


@contextlib.contextmanager
def exact_f32():
    """f32 convs and matmuls without TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def instance_norm(x):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS)


def layer_norm(x, scale, bias):
    """Per sample over (C, H, W), then a per-channel affine."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPS)
    return y * scale[None, :, None, None] + bias[None, :, None, None]


def adain(x, gamma, beta):
    return (1.0 + gamma)[:, :, None, None] * instance_norm(x) + beta[:, :, None, None]


def lrelu(x):
    return F.leaky_relu(x, LRELU)


def fake_quant(x, amax, q: int):
    """Per-tensor symmetric quantization to the integers in [-q, q]."""
    return torch.round(x * (q / amax)).clamp(-q, q)


def fp8(t):
    """``t`` through float8 e4m3 with a per-tensor scale (amax to 448), its
    gradient passed straight through: the control of a bf16 path."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    low = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (low - t).detach()


def quant_weight(w, out_dim: int, q: int):
    """Per-output-channel symmetric integer weights and their scales."""
    dims = [d for d in range(w.dim()) if d != out_dim]
    amax = w.abs().amax(dim=dims).clamp_min(1e-12)
    scale = amax / q
    shape = [1] * w.dim()
    shape[out_dim] = -1
    return torch.round(w / scale.view(shape)).clamp(-q, q), scale


class Arith:
    """How the reference computes: ``bits`` None (float) or the integer width
    of the quantized convs, with ``amax`` per conv; ``calibrate`` records the
    amax of each quantizable conv's input instead; ``tally`` counts ops by
    precision label (``labels``: "quant", "float", "head"); ``cast`` (such
    as :func:`fp8`) is applied to both operands of every float conv and
    linear."""

    def __init__(self, bits: Optional[int] = None, amax: Optional[dict] = None,
                 calibrate: bool = False, tally: Optional[dict] = None,
                 labels: Optional[dict] = None, cast=None):
        self.bits, self.amax, self.calibrate = bits, amax if amax is not None else {}, calibrate
        self.cast = cast or (lambda t: t)
        self.tally, self.labels = tally, labels or {"quant": "f32", "float": "f32", "head": "f32"}
        if bits is not None and not self.amax:
            raise ValueError("a quantized reference needs the amax of every conv")

    @property
    def q(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def _count(self, label: str, ops: int) -> None:
        if self.tally is not None:
            key = self.labels[label]
            self.tally[key] = self.tally.get(key, 0) + int(ops)

    def _record(self, key: str, x) -> None:
        if self.calibrate:
            a = x.detach().abs().amax().float()
            self.amax[key] = a if key not in self.amax else torch.maximum(self.amax[key], a)

    def conv(self, key, x, w, b=None, stride=1, pad=0, reflect=False, quantizable=False):
        if quantizable:
            self._record(key, x)
        if pad and reflect:
            x = F.pad(x, (pad,) * 4, mode="reflect")
            pad = 0
        co, ci, kh, kw = w.shape
        n = x.shape[0]
        ho = (x.shape[2] + 2 * pad - kh) // stride + 1
        wo = (x.shape[3] + 2 * pad - kw) // stride + 1
        self._count("quant" if quantizable else "float", 2 * n * co * ci * kh * kw * ho * wo)
        if quantizable and self.bits is not None:
            amax = self.amax[key]
            wq, sw = quant_weight(w, 0, self.q)
            y = F.conv2d(fake_quant(x, amax, self.q), wq, None, stride, pad)
            y = y * ((amax / self.q) * sw)[None, :, None, None]
            return y if b is None else y + b[None, :, None, None]
        return F.conv2d(self.cast(x), self.cast(w), b, stride, pad)

    def deconv(self, key, x, w, b=None, stride=2, pad=1, out_pad=1):
        """ConvTranspose2d, weight (C_in, C_out, k, k); the k3/s2/p1/op1 ones quantize."""
        ci, co, k, _ = w.shape
        quantizable = (k, stride, pad, out_pad) == (3, 2, 1, 1)
        if quantizable:
            self._record(key, x)
        n, _, h, wd = x.shape
        ho, wo = (h - 1) * stride - 2 * pad + k + out_pad, (wd - 1) * stride - 2 * pad + k + out_pad
        taps = landing_taps(h, k, stride, pad, ho) * landing_taps(wd, k, stride, pad, wo)
        self._count("quant" if quantizable else "head", 2 * n * ci * co * taps)
        if quantizable and self.bits is not None:
            amax = self.amax[key]
            wq, sw = quant_weight(w, 1, self.q)
            y = F.conv_transpose2d(fake_quant(x, amax, self.q), wq, None, stride, pad, out_pad)
            y = y * ((amax / self.q) * sw)[None, :, None, None]
            return y if b is None else y + b[None, :, None, None]
        return F.conv_transpose2d(self.cast(x), self.cast(w), b, stride, pad, out_pad)

    def linear(self, x, w, b=None):
        self._count("float", 2 * x.shape[0] * w.shape[0] * w.shape[1])
        return F.linear(self.cast(x), self.cast(w), b)


def _count(p: dict, prefix: str) -> int:
    n = 0
    while any(k.startswith(f"{prefix}{n}.") for k in p):
        n += 1
    return n


def content_encoder(p: dict, x, A: Arith, noise=None):
    """7x7 stem (IN, lrelu), stride-2 downs (IN, relu), instance-norm
    resblocks; reflect padding throughout."""
    h = lrelu(instance_norm(A.conv("ce.stem", x, p["stem.conv.weight"], p["stem.conv.bias"],
                                   1, 3, True)))
    for i in range(_count(p, "down")):
        h = torch.relu(instance_norm(A.conv(f"ce.down{i}", h, p[f"down{i}.conv.weight"],
                                            p[f"down{i}.conv.bias"], 2, 1, True, True)))
    for i in range(_count(p, "res")):
        r = torch.relu(instance_norm(A.conv(f"ce.res{i}.conv1", h, p[f"res{i}.conv1.conv.weight"],
                                            None, 1, 1, True, True)))
        r = instance_norm(A.conv(f"ce.res{i}.conv2", r, p[f"res{i}.conv2.conv.weight"],
                                 None, 1, 1, True, True))
        h = h + r
    return h if noise is None else h + noise


def style_mlp(p: dict, z, c, A: Arith):
    h = torch.cat([c, z], dim=-1)
    h = torch.relu(A.linear(h, p["linear.fc0.weight"], p["linear.fc0.bias"]))
    h = torch.relu(A.linear(h, p["linear.fc1.weight"], p["linear.fc1.bias"]))
    return A.linear(h, p["linear.fc2.weight"], p["linear.fc2.bias"])


def tail(p: dict, h, A: Arith):
    """Transposed-conv upsamples with LayerNorm and relu, then the 1x1 tanh head."""
    for i in range(_count(p, "dec2.up")):
        pre = f"dec2.up{i}"
        h = A.deconv(f"dec.up{i}", h, p[f"{pre}.conv.weight"], p[f"{pre}.conv.bias"])
        h = torch.relu(layer_norm(h, p[f"{pre}.norm.scale"], p[f"{pre}.norm.bias"]))
    return torch.tanh(A.deconv("dec.head", h, p["dec2.head.conv.weight"], None, 1, 0, 0))


def adain_decoder(p: dict, x, z, c, A: Arith):
    """The style MLP's code modulates AdaIN resblocks (one projection per
    block, shared by its two norms; relu after the first), then the tail."""
    style = style_mlp(p, z, c, A)
    for i in range(_count(p, "dec1_")):
        pre = f"dec1_{i}"
        gamma, beta = A.linear(style, p[f"{pre}.adain.style_proj.weight"],
                               p[f"{pre}.adain.style_proj.bias"]).chunk(2, dim=-1)
        h = A.conv(f"dec.{pre}.conv1", x, p[f"{pre}.conv1.conv.weight"], None, 1, 1, True, True)
        h = torch.relu(adain(h, gamma, beta))
        h = A.conv(f"dec.{pre}.conv2", h, p[f"{pre}.conv2.conv.weight"], None, 1, 1, True, True)
        x = x + adain(h, gamma, beta)
    return tail(p, x, A)


def base_decoder(p: dict, x, z, c, A: Arith):
    """BaseModel's default decoder: the style MLP's output, one ``dim``-wide
    chunk per DecResnetBlock (3x3 conv, IN, then a mix of two 1x1 convs with
    relu over [h, chunk], twice, plus the input), then the tail."""
    chunks = style_mlp(p, z, c, A)
    dim = x.shape[1]
    for i in range(_count(p, "dec1_")):
        pre = f"dec1_{i}"
        zc = chunks[:, i * dim:(i + 1) * dim]

        def mix(h, name):
            zmap = zc[:, :, None, None].expand(-1, -1, h.shape[2], h.shape[3])
            h = torch.cat([h, zmap], dim=1)
            h = torch.relu(A.conv(f"dec.{pre}.{name}_a", h, p[f"{pre}.{name}_a.weight"],
                                  p[f"{pre}.{name}_a.bias"]))
            return torch.relu(A.conv(f"dec.{pre}.{name}_b", h, p[f"{pre}.{name}_b.weight"],
                                     p[f"{pre}.{name}_b.bias"]))

        h = A.conv(f"dec.{pre}.conv1", x, p[f"{pre}.conv1.conv.weight"], None, 1, 1, True, True)
        h = mix(instance_norm(h), "block1")
        h = A.conv(f"dec.{pre}.conv2", h, p[f"{pre}.conv2.conv.weight"], None, 1, 1, True, True)
        x = x + mix(instance_norm(h), "block2")
    return tail(p, x, A)


def forward_random(weights: dict, decoder, img, z, c, A: Arith):
    """NHWC images in [-1, 1], styles (B, latent), one-hot targets -> NHWC
    translations, f32: the content encoder, then ``decoder`` (one of the
    decoders above, or a reference file's own)."""
    x = img.float().permute(0, 3, 1, 2)
    z_c = content_encoder(weights["content_encoder"], x, A)
    out = decoder(weights["decoder"], z_c, z.float(), c.float(), A)
    return out.permute(0, 2, 3, 1)


def calibrate(forward, weights: dict, batches) -> dict:
    """The amax of every quantizable conv's input over ``batches`` (dicts of
    img, z, c), computed by ``forward`` (a reference file's
    ``forward_random``) on the float path."""
    A = Arith(calibrate=True)
    with torch.no_grad():
        for b in batches:
            forward(weights, b["img"], b["z"], b["c"], A)
    return A.amax


def serve_ops(forward, weights: dict, batch: int, size: int, latent: int, domains: int,
              labels: dict) -> dict:
    """The operations of one request of ``batch`` images through ``forward``
    by precision label, counted on the meta device."""
    meta = {n: {k: v.to("meta") for k, v in sd.items()} for n, sd in weights.items()}
    tally: dict = {}
    A = Arith(tally=tally, labels=labels)
    with torch.no_grad():
        forward(meta, torch.empty((batch, size, size, 3), device="meta"),
                torch.empty((batch, latent), device="meta"),
                torch.empty((batch, domains), device="meta"), A)
    return tally
