"""The nets of AdaINModel and BaseModel (NCHW).

Ports of ``masterthesis_tpu/models/networks.py``: ``ContentEncoder``,
``StyleEncoder``, ``ReparameterizedStyleEncoder``, ``_StyleMLP``,
``_DecoderTail``, ``AdaINDecoder``, ``Decoder`` and ``DecoderConcat``, for
training ``Discriminator``, ``MultiScaleDiscriminator`` and
``ContentDiscriminator``, and ``ResnetGenerator``, with the Flax child
names (``stem``, ``down0``, ``res0``, ``head``, ``linear.fc0``, ``dec1_0``,
``dec2.up0``, ``dec2.up0.conv.conv`` (a nearest or pixelshuffle up),
``dec2.head``, ``dec_share``, ``dec3``, ``dec4``, ``layer0``,
``patch_head``, ``cls_head``, ``dis_head``). Channel concats follow the JAX
order: [x, c] for the domain map, [h, z] for the style map, and
DecoderConcat's [content, c, z].

A decoder's ``forward`` takes ``masks``, a mask source for its ``dropout``
blocks: ``masks(block name, shape)`` gives the keep mask of that block
(``dec1_0``, ...) at the shape of its input, which is its output's (the
blocks are residual), or None. Without a source, or where it gives None, a
block is deterministic.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from masterthesis_tpu_torch.models.blocks import (
    AdaINResnetBlock,
    Conv2d,
    ConvBlock,
    DecResnetBlock,
    Dense,
    DownResnetBlock,
    GaussianNoise,
    ResnetBlock,
    UpsampleBlock,
    avg_pool2d,
    concat_label,
    get_activation,
    global_avg_pool,
)
from masterthesis_tpu_torch.utils import profiling

MAX_FILTER_SIZE = 256


MaskSource = Callable[[str, torch.Size], Optional[torch.Tensor]]


def _mask(masks: Optional[MaskSource], name: str, block: nn.Module,
          h: torch.Tensor) -> Optional[torch.Tensor]:
    """The keep mask that ``masks`` gives the block ``name`` on its input h,
    or None for a block without ``dropout``."""
    return masks(name, h.shape) if masks is not None and block.dropout else None


class ContentEncoder(nn.Module):
    """7x7 stem -> num_downs stride-2 convs -> n_blocks resblocks.
    Output channels: dim * 2**num_downs."""

    def __init__(self, input_dim: int = 3, dim: int = 64, num_downs: int = 2, n_blocks: int = 4,
                 norm: Optional[str] = "instance", padding_type: str = "reflect",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        common = dict(use_bias=use_bias, norm=norm, padding_type=padding_type, dtype=dtype)
        self.stem = ConvBlock(input_dim, dim, 7, 1, 3, activation="lrelu", **common)
        d = dim
        for i in range(num_downs):
            setattr(self, f"down{i}", ConvBlock(d, 2 * d, 3, 2, 1, activation="relu", **common))
            d *= 2
        self.num_downs, self.n_blocks, self.output_dim = num_downs, n_blocks, d
        for i in range(n_blocks):
            setattr(self, f"res{i}", ResnetBlock(d, norm=norm, activation="relu", dtype=dtype))
        self.noise = GaussianNoise()

    def code_shape(self, x_shape) -> tuple[int, int, int, int]:
        """The NCHW shape of the content code of an NCHW input shape."""
        n, _, h, w = x_shape
        for _ in range(self.num_downs):
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        return n, self.output_dim, h, w

    def forward(self, x, noise: Optional[torch.Tensor] = None):
        """The stem and each down defer their instance norm and activation
        into the next down's quantize prologue where that down's conv runs
        int8 (int8 serving), with the downs' statistics from their kernels;
        the last down applies its own. ``noise``: the training noise on the
        code (:meth:`code_shape`), or None."""
        blocks = [self.stem] + [getattr(self, f"down{i}") for i in range(self.num_downs)]
        h, pending = x, None
        for block, consumer in zip(blocks, blocks[1:] + [None]):
            defer = consumer is not None and consumer.conv.int8
            h, pending = block(h, pending, defer_norm=True) if defer else (block(h, pending), None)
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)
        return self.noise(h, noise)


class StyleEncoder(nn.Module):
    """BaseModel's plain style encoder: a 7x7 stem over [x, c], ``num_downs``
    4x4/s2 reflect-padded downs (no norm, no bias), global average pooling
    and a 1x1 head with bias to the latent code."""

    def __init__(self, input_dim: int = 3, output_dim: int = 8, dim: int = 64,
                 num_downs: int = 4, num_domains: int = 2, activation: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        common = dict(padding_type="reflect", activation=activation, dtype=dtype)
        self.stem = ConvBlock(input_dim + num_domains, dim, 7, 1, 3, **common)
        d = dim
        for i in range(num_downs):
            setattr(self, f"down{i}", ConvBlock(min(MAX_FILTER_SIZE, d), min(MAX_FILTER_SIZE, d * 2),
                                                4, 2, 1, **common))
            d *= 2
        self.num_downs = num_downs
        self.head = Conv2d(min(MAX_FILTER_SIZE, d), output_dim, 1, dtype=dtype)

    def forward(self, x, c):
        h = self.stem(concat_label(x, c))
        for i in range(self.num_downs):
            h = getattr(self, f"down{i}")(h)
        h = self.head(global_avg_pool(h)[:, :, None, None])
        return h.reshape(h.shape[0], -1)


class ReparameterizedStyleEncoder(nn.Module):
    """VAE style encoder returning (z, mu, logvar).

    The JAX module draws its eps from a flax rng stream; here the caller hands
    eps in (``None`` gives z = mu, the deterministic path).
    """

    def __init__(self, input_dim: int = 3, output_dim: int = 8, dim: int = 64, n_blocks: int = 4,
                 num_domains: int = 2, norm: Optional[str] = None, activation: str = "lrelu",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        # the stem is a 4x4/s2/p1 reflect conv with neither norm nor activation
        self.stem = ConvBlock(input_dim + num_domains, dim, 4, 2, 1, use_bias=use_bias,
                              padding_type="reflect", dtype=dtype)
        d = dim
        for i in range(1, n_blocks):
            out_d = min(MAX_FILTER_SIZE, d * 2)
            setattr(self, f"down{i}", DownResnetBlock(
                min(MAX_FILTER_SIZE, d), out_d, norm=norm, activation=activation,
                use_bias=use_bias, dtype=dtype,
            ))
            d *= 2
        self.n_blocks = n_blocks
        self.act = get_activation(activation)
        self.fc = Dense(min(MAX_FILTER_SIZE, d), output_dim, dtype=dtype)
        self.fcVar = Dense(min(MAX_FILTER_SIZE, d), output_dim, dtype=dtype)

    def forward(self, x, c, eps: Optional[torch.Tensor] = None):
        h = self.stem(concat_label(x, c))
        for i in range(1, self.n_blocks):
            h = getattr(self, f"down{i}")(h)
        h = global_avg_pool(self.act(h))
        mu, logvar = self.fc(h), self.fcVar(h)
        z = mu if eps is None else mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar)
        return z, mu, logvar


class _StyleMLP(nn.Module):
    """(z, c) -> style vector: three Dense layers on [c, z] (that order)."""

    def __init__(self, in_features: int, out_features: int, hidden: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc0 = Dense(in_features, hidden, dtype=dtype)
        self.fc1 = Dense(hidden, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out_features, dtype=dtype)

    def forward(self, z, c):
        h = torch.cat([c.to(z.dtype), z], dim=-1)
        h = torch.relu(self.fc0(h))
        h = torch.relu(self.fc1(h))
        return self.fc2(h)


class _DecoderTail(nn.Module):
    """num_ups upsamples with norm + activation, then the tanh head: with
    ``transpose`` a 1x1 transposed conv (no bias), with ``nearest`` or
    ``pixelshuffle`` a 7x7 ``ConvBlock`` (zero padding 3, no bias)."""

    def __init__(self, output_dim: int, dim: int, num_ups: int = 2, up_type: str = "transpose",
                 norm: Optional[str] = "layer", activation: Optional[str] = "relu",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dim
        for i in range(num_ups):
            setattr(self, f"up{i}", UpsampleBlock(
                d, d // 2, 3, 2, 1, 1, use_bias=use_bias, norm=norm, activation=activation,
                up_type=up_type, dtype=dtype,
            ))
            d //= 2
        self.num_ups = num_ups
        if "transpose" in up_type:
            self.head = UpsampleBlock(d, output_dim, 1, 1, 0, activation="tanh", dtype=dtype)
        else:
            self.head = ConvBlock(d, output_dim, 7, 1, 3, activation="tanh", dtype=dtype)

    def forward(self, h):
        """int8 serving: each int8 transposed upsample hands its LayerNorm +
        relu to the next one's quantize prologue, the last one to the head,
        kernel 8; every other upsample applies its own (as in the JAX package
        for the other up types)."""
        pending = None
        for i in range(self.num_ups):
            h, pending = getattr(self, f"up{i}")(h, pending, defer_norm=True)
        return self.head(h, pending)


class AdaINDecoder(nn.Module):
    """One style code from the style MLP modulates n_blocks AdaIN resblocks,
    then the upsampling tail. With a ``res_norm`` other than ``adain`` the
    blocks are instance-norm ``ResnetBlock``s and there is no style MLP (the
    style is unused), as in the JAX package; int8 serving runs them through
    the whole-block kernel 6. ``dropout`` routes the blocks as in the JAX
    package and applies the given masks (see :class:`AdaINResnetBlock`)."""

    def __init__(self, output_dim: int = 3, dim: int = 256, n_blocks: int = 4,
                 num_domains: int = 2, num_ups: int = 2, latent_dim: int = 8,
                 up_type: str = "transpose", res_norm: str = "adain",
                 norm: Optional[str] = "layer", activation: Optional[str] = "relu",
                 use_bias: bool = True, dropout: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adain = "adain" in res_norm
        if self.adain:
            self.linear = _StyleMLP(latent_dim + num_domains, dim, dtype=dtype)
        for i in range(n_blocks):
            block = (AdaINResnetBlock(dim, dim, dropout=dropout, dtype=dtype) if self.adain
                     else ResnetBlock(dim, dropout=dropout, dtype=dtype))
            setattr(self, f"dec1_{i}", block)
        self.n_blocks = n_blocks
        self.dec2 = _DecoderTail(output_dim, dim, num_ups, up_type, norm, activation,
                                 use_bias, dtype=dtype)

    def forward(self, x, z, c, masks: Optional[MaskSource] = None):
        style = self.linear(z, c) if self.adain else None
        h = x
        for i in range(self.n_blocks):
            name = f"dec1_{i}"
            block = getattr(self, name)
            mask = _mask(masks, name, block, h)
            h = block(h, style, mask) if self.adain else block(h, mask)
        return self.dec2(h)


class Decoder(nn.Module):
    """BaseModel's default decoder: the style MLP's output, split into one
    ``dim``-wide chunk per block, feeds n_blocks DecResnetBlocks, then the
    upsampling tail. ``dropout`` goes to every block, which applies its
    mask after its second mix (the blocks' convs run kernel 4 in int8
    serving either way)."""

    def __init__(self, output_dim: int = 3, dim: int = 256, n_blocks: int = 4,
                 num_domains: int = 2, num_ups: int = 2, latent_dim: int = 8,
                 up_type: str = "transpose", dropout: bool = False,
                 norm: Optional[str] = "layer", activation: Optional[str] = "relu",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = _StyleMLP(latent_dim + num_domains, dim * n_blocks, dtype=dtype)
        for i in range(n_blocks):
            setattr(self, f"dec1_{i}", DecResnetBlock(dim, dim, dropout=dropout, dtype=dtype))
        self.dim, self.n_blocks = dim, n_blocks
        self.dec2 = _DecoderTail(output_dim, dim, num_ups, up_type, norm, activation,
                                 use_bias, dtype=dtype)

    def forward(self, x, z, c, masks: Optional[MaskSource] = None):
        chunks = self.linear(z, c)
        h = x
        for i in range(self.n_blocks):
            name = f"dec1_{i}"
            block = getattr(self, name)
            h = block(h, chunks[:, i * self.dim:(i + 1) * self.dim], _mask(masks, name, block, h))
        return self.dec2(h)


class DecoderConcat(nn.Module):
    """BaseModel's ``--concat`` decoder: a shared resblock, then [h, c, z]
    through n_blocks resblocks, and z concatenated again before each of two
    upsamples and the tanh head (``dec4``, no bias: a 1x1 transposed conv,
    or with ``nearest``/``pixelshuffle`` a 7x7 ``ConvBlock``).
    With dim 256, latent 8 and 4 domains the widths are 268 (resblocks),
    276 -> 138, 146 -> 73 and 81 -> 3. ``dropout`` goes to the ``dec1_*``
    blocks, not to ``dec_share``, as in the JAX package.

    int8 serving with transposed ups and a LayerNorm: ``dec3`` hands its
    LayerNorm and relu to the head, kernel 8 (as ``_DecoderTail`` does), and
    ``dec4``, given z as its ``code``, takes the z channels' share of its
    1x1 sum as one term per image, ``t = z W_z^T`` (``khead.head``'s ``t``),
    in place of the last [h, z] concat. Every other route (float, training,
    QAT, calibration, ``nearest``/``pixelshuffle``) concatenates z before
    ``dec4``.

    Each concat ([h, c], [h, c, z] and the [h, z]: four on the int8 route
    above, five elsewhere) runs under the span ``mt.decode.concat``
    (``channels`` out, ``height``) and adds the bytes it writes to the
    counter ``decode.concat_bytes`` while the program's recorder is on
    (``utils/profiling.py``)."""

    def __init__(self, output_dim: int = 3, dim: int = 256, n_blocks: int = 3,
                 num_domains: int = 2, latent_dim: int = 8, up_type: str = "transpose",
                 dropout: bool = False, norm: Optional[str] = "layer",
                 activation: Optional[str] = "relu", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dec_share = ResnetBlock(dim, dtype=dtype)
        nch = dim + latent_dim + num_domains
        for i in range(n_blocks):
            setattr(self, f"dec1_{i}", ResnetBlock(nch, dropout=dropout, dtype=dtype))
        self.n_blocks = n_blocks
        up = dict(use_bias=use_bias, norm=norm, activation=activation, up_type=up_type, dtype=dtype)
        nch += latent_dim
        self.dec2 = UpsampleBlock(nch, nch // 2, 3, 2, 1, 1, **up)
        nch = nch // 2 + latent_dim
        self.dec3 = UpsampleBlock(nch, nch // 2, 3, 2, 1, 1, **up)
        if "transpose" in up_type:
            self.dec4 = UpsampleBlock(nch // 2 + latent_dim, output_dim, 1, 1, 0,
                                      activation="tanh", dtype=dtype)
        else:
            self.dec4 = ConvBlock(nch // 2 + latent_dim, output_dim, 7, 1, 3, activation="tanh",
                                  dtype=dtype)

    @staticmethod
    def _concat(h, code):
        if not profiling.ON:
            return concat_label(h, code)
        with profiling.span("mt.decode.concat",
                            {"channels": h.shape[1] + code.shape[1], "height": h.shape[2]}):
            out = concat_label(h, code)
        profiling.add("decode.concat_bytes", out.numel() * out.element_size())
        return out

    def forward(self, x, z, c, masks: Optional[MaskSource] = None):
        h = self._concat(self._concat(self.dec_share(x), c), z)
        for i in range(self.n_blocks):
            name = f"dec1_{i}"
            block = getattr(self, name)
            h = block(h, _mask(masks, name, block, h))
        h = self.dec2(self._concat(h, z))
        h, pending = self.dec3(self._concat(h, z), defer_norm=True)
        return self.dec4(self._concat(h, z)) if pending is None else self.dec4(h, pending, code=z)


class Discriminator(nn.Module):
    """PatchGAN discriminator with a domain classifier; returns
    (patch logits (N, 1, h, w), class logits (N, num_domains)).

    ``n_layers`` stride-2 3x3 convs (the last without a norm; spectrally
    normalized with ``sn``), then a 1x1 patch head with zero padding 1 and no
    bias, and a class head whose kernel covers the remaining map
    (``image_size / 2**n_layers``), averaged."""

    def __init__(self, input_dim: int = 3, dim: int = 64, n_layers: int = 6,
                 num_domains: int = 2, norm: Optional[str] = None, activation: str = "lrelu",
                 padding_type: str = "reflect", use_bias: bool = True, image_size: int = 256,
                 sn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        common = dict(use_bias=use_bias, activation=activation, padding_type=padding_type,
                      sn=sn, dtype=dtype)
        d = dim
        self.layer0 = ConvBlock(input_dim, d, 3, 2, 1, norm=norm, **common)
        for i in range(n_layers - 2):
            setattr(self, f"layer{i + 1}", ConvBlock(d, 2 * d, 3, 2, 1, norm=norm, **common))
            d *= 2
        setattr(self, f"layer{n_layers - 1}", ConvBlock(d, d, 3, 2, 1, **common))
        self.n_layers = n_layers
        self.patch_head = Conv2d(d, 1, 1, 1, 1, use_bias=False, dtype=dtype)
        k = max(1, int(image_size / (2**n_layers)))
        self.cls_head = Conv2d(d, num_domains, k, 1, 0, use_bias=False, dtype=dtype)

    def forward(self, x):
        h = x
        for i in range(self.n_layers):
            h = getattr(self, f"layer{i}")(h)
        return self.patch_head(h), global_avg_pool(self.cls_head(h))


class MultiScaleDiscriminator(nn.Module):
    """One trunk applied at ``num_scales`` scales of the input, each scale
    pooled from the last by a 3x3/s2 average (padding 1, padding not
    counted). Returns a list of (patch logits (N, 1, h, w), class logits
    (N, num_domains)), one per scale.

    The trunk: ``n_layers`` 4x4/s2 convs with zero padding 1 and no bias,
    ``dim`` doubling after the first (64 -> 2048 at six layers), all but the
    first normed, spectrally normalized with ``sn``; then a 1x1 ``dis_head``
    and a 1x1 ``cls_head``, both with bias, the class logits averaged."""

    def __init__(self, input_dim: int = 3, dim: int = 64, n_layers: int = 6,
                 num_domains: int = 2, norm: Optional[str] = None, activation: str = "lrelu",
                 padding_type: Optional[str] = None, num_scales: int = 3, sn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        common = dict(activation=activation, padding_type=padding_type, sn=sn, dtype=dtype)
        self.layer0 = ConvBlock(input_dim, dim, 4, 2, 1, **common)
        d = dim
        for i in range(n_layers - 1):
            setattr(self, f"layer{i + 1}", ConvBlock(d, 2 * d, 4, 2, 1, norm=norm, **common))
            d *= 2
        self.n_layers, self.num_scales = n_layers, num_scales
        self.dis_head = Conv2d(d, 1, 1, 1, 0, use_bias=True, dtype=dtype)
        self.cls_head = Conv2d(d, num_domains, 1, 1, 0, use_bias=True, dtype=dtype)

    def forward(self, x):
        outputs = []
        for _ in range(self.num_scales):
            h = x
            for i in range(self.n_layers):
                h = getattr(self, f"layer{i}")(h)
            outputs.append((self.dis_head(h), global_avg_pool(self.cls_head(h))))
            x = avg_pool2d(x, 3, 2, padding=1, count_include_pad=False)
        return outputs


class ContentDiscriminator(nn.Module):
    """Domain classifier on content codes: ``n_layers`` stride-2 convs with
    norm, a VALID ``final_kernel`` conv (always named ``layer3``), a 1x1
    head, averaged to (N, num_domains) logits."""

    def __init__(self, input_dim: int = 256, dim: int = 256, num_domains: int = 3,
                 norm: Optional[str] = "instance", activation: str = "lrelu",
                 padding_type: str = "reflect", use_bias: bool = True, n_layers: int = 3,
                 kernel_size: int = 7, final_kernel: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        common = dict(use_bias=use_bias, activation=activation, padding_type=padding_type,
                      dtype=dtype)
        d = input_dim
        for i in range(n_layers):
            setattr(self, f"layer{i}", ConvBlock(d, dim, kernel_size, 2, 1, norm=norm, **common))
            d = dim
        self.layer3 = ConvBlock(d, dim, final_kernel, 1, 0, **common)
        self.head = Conv2d(dim, num_domains, 1, 1, 0, use_bias=True, dtype=dtype)
        self.n_layers = n_layers

    def forward(self, x):
        h = x
        for i in range(self.n_layers):
            h = getattr(self, f"layer{i}")(h)
        return global_avg_pool(self.head(self.layer3(h)))


class ResnetGenerator(nn.Module):
    """A plain residual encoder-decoder: a 7x7 stem, ``num_downs`` stride-2
    3x3 downs, ``n_blocks`` instance-norm resblocks (``norm`` if given; the
    original builds none, DESIGN.md divergence 9), ``num_downs`` transposed
    upsamples (``up{i}``, widest last) and a 7x7 tanh head. No conv has a
    bias. Neither model builds it."""

    def __init__(self, input_dim: int = 3, output_dim: int = 3, dim: int = 64,
                 num_downs: int = 2, n_blocks: int = 6, norm: Optional[str] = None,
                 activation: Optional[str] = None, padding_type: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        common = dict(norm=norm, padding_type=padding_type, dtype=dtype)
        self.stem = ConvBlock(input_dim, dim, 7, 1, 3, activation=activation, **common)
        for i in range(num_downs):
            setattr(self, f"down{i}", ConvBlock(dim * 2 ** i, dim * 2 ** (i + 1), 3, 2, 1,
                                                activation=activation, **common))
        d = dim * 2 ** num_downs
        for i in range(n_blocks):
            setattr(self, f"res{i}", ResnetBlock(d, norm=norm or "instance", dtype=dtype))
        for i in reversed(range(num_downs)):
            setattr(self, f"up{i}", UpsampleBlock(dim * 2 ** (i + 1), dim * 2 ** i, 3, 2, 1, 1,
                                                  norm=norm, activation=activation,
                                                  padding_type=padding_type, dtype=dtype))
        self.head = ConvBlock(dim, output_dim, 7, 1, 3, activation="tanh", **common)
        self.num_downs, self.n_blocks = num_downs, n_blocks

    def forward(self, x):
        h = self.stem(x)
        for i in range(self.num_downs):
            h = getattr(self, f"down{i}")(h)
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)
        for i in reversed(range(self.num_downs)):
            h = getattr(self, f"up{i}")(h)
        return self.head(h)
