"""Models of the port (inference)."""
from masterthesis_tpu_torch.models.adain_model import AdaINModel

__all__ = ["AdaINModel"]
