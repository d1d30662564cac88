"""Models of the port: AdaINModel (serving and training), BaseModel (serving)."""
from masterthesis_tpu_torch.models.adain_model import AdaINModel
from masterthesis_tpu_torch.models.base_model import BaseModel

__all__ = ["AdaINModel", "BaseModel"]
