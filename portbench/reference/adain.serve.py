"""AdaINModel's served forward (configuration ``reference: "adain"``): the
content encoder, the style MLP, AdaIN resblocks, the transposed-conv tail
and the tanh head."""
from portbench.reference import nets


def forward_random(weights: dict, img, z, c, A: nets.Arith):
    return nets.forward_random(weights, nets.adain_decoder, img, z, c, A)
