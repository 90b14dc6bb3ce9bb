"""The port's input pipeline: the MNIST IDX parser, the deterministic
synthetic MNIST and the epoch iterator (``data/mnist.py``), and the host
path's prefetchers (``data/prefetch.py``)."""

from .mnist import (DataSplit, Dataset, EpochIterator, load_datasets,
                    synthesize_dataset, synthesize_split)
from .prefetch import (CopyStreamCommit, DevicePrefetcher, EpochPrefetcher,
                       Prefetcher, pinned_batches, take)

__all__ = ["DataSplit", "Dataset", "EpochIterator", "load_datasets",
           "synthesize_dataset", "synthesize_split", "CopyStreamCommit",
           "DevicePrefetcher", "EpochPrefetcher", "Prefetcher",
           "pinned_batches", "take"]
