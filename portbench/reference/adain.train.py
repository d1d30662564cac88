"""AdaINModel's training iterations (configuration ``reference: "adain"``):
the shared step of :mod:`portbench.reference.train` with the AdaIN decoder
and the VAE style encoder."""
from portbench.reference import nets, train


class Step(train.Step):
    decoder = staticmethod(nets.adain_decoder)
    style_encoder = staticmethod(train.style_encoder)


draw_shapes = train.draw_shapes
