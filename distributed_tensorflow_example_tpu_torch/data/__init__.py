"""The port's input pipeline: the MNIST IDX parser, the deterministic
synthetic MNIST and the epoch iterator (``data/mnist.py``)."""

from .mnist import (DataSplit, Dataset, EpochIterator, load_datasets,
                    synthesize_dataset, synthesize_split)

__all__ = ["DataSplit", "Dataset", "EpochIterator", "load_datasets",
           "synthesize_dataset", "synthesize_split"]
