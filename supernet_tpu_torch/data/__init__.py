"""The port's data pipeline: NumPy loaders, .npy shards, NIfTI ingestion,
synthetic data and on-device augmentation."""

from supernet_tpu_torch.configs import AugmentConfig
from supernet_tpu_torch.data.augment import (
    augment_batch,
    augment_train_batch,
    augment_volumes,
)
from supernet_tpu_torch.data.loaders import (
    BatchIterator,
    PickleDataset,
    StreamingPickleDataset,
    center_crop_np,
    expand_to_shape,
    load_hippocampus_pickle,
)
from supernet_tpu_torch.data.nifti import (
    convert_nifti_dir,
    read_nifti,
    volume_to_cube,
    volume_to_slices,
    write_nifti,
)
from supernet_tpu_torch.data.shards import (
    ShardDataset,
    convert_pickles,
    shard_pairs,
    write_shards,
)
from supernet_tpu_torch.data.synthetic import (
    synthetic_dataset,
    synthetic_volumes,
)

__all__ = [
    "AugmentConfig",
    "augment_batch",
    "augment_train_batch",
    "augment_volumes",
    "BatchIterator",
    "PickleDataset",
    "ShardDataset",
    "StreamingPickleDataset",
    "center_crop_np",
    "expand_to_shape",
    "convert_nifti_dir",
    "convert_pickles",
    "load_hippocampus_pickle",
    "read_nifti",
    "shard_pairs",
    "synthetic_dataset",
    "synthetic_volumes",
    "volume_to_cube",
    "volume_to_slices",
    "write_nifti",
    "write_shards",
]
