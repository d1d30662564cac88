"""The data tier: datasets by name (``--dataset``), the loader and the
device feed. The port of ``masterthesis_tpu/data``."""
from masterthesis_tpu_torch.data.datasets import (  # noqa: F401
    ImageFolder,
    ImageList,
    PairedDataset,
    PairedImageDataset,
    SingleDataset,
    VideoDataset,
)
from masterthesis_tpu_torch.data.loader import (  # noqa: F401
    DataLoader,
    collate,
    infinite,
    shard_batch,
    to_device,
)
