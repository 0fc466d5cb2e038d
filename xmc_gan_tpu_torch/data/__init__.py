"""Host-side input pipeline: datasets, augmentation, sharded loaders (numpy
and PIL; the port's copy of ``xmc_gan_tpu/data``)."""

from xmc_gan_tpu_torch.data.pipeline import (  # noqa: F401
    DataLoader,
    SentTextDataset,
    SyntheticDataset,
    WordTextDataset,
    index_to_sent,
)
