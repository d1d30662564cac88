"""BaseModel A's served forward (configuration ``reference: "base"``): the
content encoder, the style MLP cut into one chunk per block, DecResnet
blocks with their 1x1 mix convs, the transposed-conv tail and the tanh
head."""
from portbench.reference import nets


def forward_random(weights: dict, img, z, c, A: nets.Arith):
    return nets.forward_random(weights, nets.base_decoder, img, z, c, A)
