"""BaseModel config B's served forward (configuration ``reference:
"base_b"``, ``--concat --reparam``): the content encoder, then the concat
decoder of kartikkadur/MasterThesis (``src/models/core/networks.py``
``DecoderConcat``, :272-333), written out here from its layer equations in
f32 with the parts of ``nets``:

1. ``dec_share``: an instance-norm resblock at the content code's width (two
   reflect-padded 3x3 convs without bias, IN, relu between them, plus the
   input);
2. the one-hot target c and the style z broadcast over space and
   concatenated after h on channels, [h, c] and then [h, c, z];
3. ``dec1_0`` .. ``dec1_2``: three such resblocks at dim + domains + latent
   channels;
4. ``dec2``, ``dec3``: z concatenated again, a k3/s2/p1/op1 transposed conv
   with bias, LayerNorm (per sample over C, H, W, then a per-channel
   affine), relu;
5. ``dec4``: z concatenated once more, a 1x1 conv without bias, tanh.

At dim 256, latent 8 and 4 domains the widths are 256, 260 and 268 (the
resblocks), 276 -> 138, 146 -> 73 and 81 -> 3.

Departures from networks.py:272-333:

- Serving only. ``forward_random`` takes z from its caller, so the
  reparameterized style encoder (``--reparam``) never runs, and the dec1
  blocks' dropout, off at test time, is left out.
- The head, a 1x1 stride-1 transposed conv without bias, is written as the
  1x1 conv with its weight transposed: the same sums. Its operations so
  count under "float", the precision the program runs it in (bf16 through
  cuDNN; no int8 kernel takes this head), and not under "head".
- With ``A.bits`` set, every 3x3 pad-1 conv of the resblocks and both
  transposed upsamples quantize their input per tensor and their weights per
  output channel, as the program's int8 serving path does; the original has
  no quantized path. The stem, the head and the norms stay f32.
"""
import torch

from portbench.reference import nets


def _with(h, code):
    """``code`` (N, K) broadcast over h's H, W and concatenated after h."""
    n, _, hh, ww = h.shape
    return torch.cat([h, code[:, :, None, None].expand(n, code.shape[1], hh, ww)], dim=1)


def _resblock(p: dict, pre: str, x, A: nets.Arith):
    r = torch.relu(nets.instance_norm(A.conv(f"dec.{pre}.conv1", x, p[f"{pre}.conv1.conv.weight"],
                                             None, 1, 1, True, True)))
    r = nets.instance_norm(A.conv(f"dec.{pre}.conv2", r, p[f"{pre}.conv2.conv.weight"],
                                  None, 1, 1, True, True))
    return x + r


def concat_decoder(p: dict, x, z, c, A: nets.Arith):
    h = _with(_with(_resblock(p, "dec_share", x, A), c), z)
    for i in range(nets._count(p, "dec1_")):
        h = _resblock(p, f"dec1_{i}", h, A)
    for pre in ("dec2", "dec3"):
        h = A.deconv(f"dec.{pre}", _with(h, z), p[f"{pre}.conv.weight"], p[f"{pre}.conv.bias"])
        h = torch.relu(nets.layer_norm(h, p[f"{pre}.norm.scale"], p[f"{pre}.norm.bias"]))
    head = p["dec4.conv.weight"].transpose(0, 1)
    return torch.tanh(A.conv("dec.dec4", _with(h, z), head))


def forward_random(weights: dict, img, z, c, A: nets.Arith):
    return nets.forward_random(weights, concat_decoder, img, z, c, A)
