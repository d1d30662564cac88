"""The model registry (``--model`` names to classes): AdaINModel and
BaseModel, both serving and training, and their base classes."""
from masterthesis_tpu_torch.models.adain_model import AdaINModel
from masterthesis_tpu_torch.models.base_model import BaseModel
from masterthesis_tpu_torch.models.model import Model
from masterthesis_tpu_torch.models.state import TrainState

__all__ = ["AdaINModel", "BaseModel", "Model", "TrainState"]
