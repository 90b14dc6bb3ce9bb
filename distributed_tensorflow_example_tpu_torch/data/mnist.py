"""MNIST input pipeline: the port's copy of the JAX package's
``data/mnist.py``.

- the IDX parser for the four standard MNIST files (``*-idx3-ubyte`` /
  ``*-idx1-ubyte``, optionally ``.gz``), checked against the IDX magic
  numbers, with the TF tutorial's split (the 60,000-example train file
  becomes 55,000 train + 5,000 validation);
- the deterministic synthetic MNIST (upscaled digit glyphs with jitter
  and noise, quantised to the 8-bit pixel grid), bit-identical to the
  JAX package's for the same seed and sizes;
- ``EpochIterator``, the reference's ``next_batch``: one permutation
  per epoch keyed by ``RandomState([seed, epoch])``, optionally sharded
  ``p::P`` over processes; batches are numpy fancy indexing, the same
  arrays as the JAX package's native gather.

The port does not download: ``--dataset=mnist`` without the IDX files in
``--data_dir`` is refused (``config.Unported``).  ``auto`` uses the files
when present and the synthetic data otherwise.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Iterator, List, Tuple

import numpy as np

IMAGE_MAGIC = 0x00000803
LABEL_MAGIC = 0x00000801

TRAIN_IMAGES = "train-images-idx3-ubyte"
TRAIN_LABELS = "train-labels-idx1-ubyte"
TEST_IMAGES = "t10k-images-idx3-ubyte"
TEST_LABELS = "t10k-labels-idx1-ubyte"

VALIDATION_SIZE = 5000  # TF tutorial split: 60k -> 55k train + 5k validation


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def parse_idx_images(data: bytes) -> np.ndarray:
    """Parse an IDX3 image file into uint8 [N, rows, cols]."""
    if len(data) < 16:
        raise ValueError(f"IDX image file too short ({len(data)} bytes); "
                         f"bad magic/header")
    magic, n, rows, cols = struct.unpack(">IIII", data[:16])
    if magic != IMAGE_MAGIC:
        raise ValueError(f"bad IDX image magic 0x{magic:08x}, want "
                         f"0x{IMAGE_MAGIC:08x}")
    arr = np.frombuffer(data, dtype=np.uint8, count=n * rows * cols,
                        offset=16)
    return arr.reshape(n, rows, cols)


def parse_idx_labels(data: bytes) -> np.ndarray:
    """Parse an IDX1 label file into uint8 [N]."""
    if len(data) < 8:
        raise ValueError(f"IDX label file too short ({len(data)} bytes); "
                         f"bad magic/header")
    magic, n = struct.unpack(">II", data[:8])
    if magic != LABEL_MAGIC:
        raise ValueError(f"bad IDX label magic 0x{magic:08x}, want "
                         f"0x{LABEL_MAGIC:08x}")
    return np.frombuffer(data, dtype=np.uint8, count=n, offset=8)


def one_hot(labels: np.ndarray, num_classes: int = 10) -> np.ndarray:
    out = np.zeros((labels.shape[0], num_classes), dtype=np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


@dataclasses.dataclass
class DataSplit:
    """Flattened float32 images in [0, 1] and one-hot labels."""

    images: np.ndarray  # [N, 784] float32
    labels: np.ndarray  # [N, 10] float32 one-hot

    @property
    def num_examples(self) -> int:
        return self.images.shape[0]


@dataclasses.dataclass
class Dataset:
    train: DataSplit
    validation: DataSplit
    test: DataSplit
    source: str  # "mnist" or "synthetic"


# ---------------------------------------------------------------------------
# Synthetic MNIST (offline, deterministic)
# ---------------------------------------------------------------------------

# 5x7 bitmap glyphs for digits 0-9 (classic dot-matrix font), row-major.
_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph_array(digit: int) -> np.ndarray:
    g = _GLYPHS[digit]
    return np.array([[int(c) for c in row] for row in g], dtype=np.float32)


def synthesize_split(n: int, seed: int, input_size: int = 784) -> DataSplit:
    """MNIST-shaped data: 3x-upscaled glyphs placed with +-3 px jitter,
    random intensity, Gaussian noise, clipped to [0, 1] and quantised to
    k/255.  ``input_size != 784`` tiles or truncates each flattened
    image to that width."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    images = np.zeros((n, 28, 28), dtype=np.float32)
    glyphs = {d: np.kron(_glyph_array(d), np.ones((3, 3), np.float32))
              for d in range(10)}
    gh, gw = 21, 15
    for i in range(n):
        gy = 3 + rng.randint(-3, 4)
        gx = 6 + rng.randint(-3, 4)
        intensity = 0.6 + 0.4 * rng.rand()
        images[i, gy: gy + gh, gx: gx + gw] = glyphs[labels[i]] * intensity
    images += rng.normal(0.0, 0.08, size=images.shape).astype(np.float32)
    np.clip(images, 0.0, 1.0, out=images)
    images = np.round(images * 255.0).astype(np.float32) / np.float32(255.0)
    flat = images.reshape(n, 784)
    if input_size != 784:
        flat = np.ascontiguousarray(
            np.tile(flat, (1, -(-input_size // 784)))[:, :input_size])
    return DataSplit(images=flat, labels=one_hot(labels))


def synthesize_dataset(seed: int = 0, train_size: int = 55000,
                       test_size: int = 10000,
                       input_size: int = 784) -> Dataset:
    return Dataset(
        train=synthesize_split(train_size, seed=seed + 1,
                               input_size=input_size),
        validation=synthesize_split(max(train_size // 11, 10),
                                    seed=seed + 2, input_size=input_size),
        test=synthesize_split(test_size, seed=seed + 3,
                              input_size=input_size),
        source="synthetic",
    )


# ---------------------------------------------------------------------------
# Real MNIST from IDX files on disk
# ---------------------------------------------------------------------------


def load_idx_dataset(data_dir: str) -> Dataset:
    def read(name: str) -> bytes:
        with _open_maybe_gz(os.path.join(data_dir, name)) as f:
            return f.read()

    train_images = parse_idx_images(read(TRAIN_IMAGES))
    train_labels = parse_idx_labels(read(TRAIN_LABELS))
    test_images = parse_idx_images(read(TEST_IMAGES))
    test_labels = parse_idx_labels(read(TEST_LABELS))

    def to_split(imgs: np.ndarray, lbls: np.ndarray) -> DataSplit:
        flat = imgs.reshape(imgs.shape[0], -1).astype(np.float32) / 255.0
        return DataSplit(images=flat, labels=one_hot(lbls))

    return Dataset(
        train=to_split(train_images[VALIDATION_SIZE:],
                       train_labels[VALIDATION_SIZE:]),
        validation=to_split(train_images[:VALIDATION_SIZE],
                            train_labels[:VALIDATION_SIZE]),
        test=to_split(test_images, test_labels),
        source="mnist",
    )


def idx_files_present(data_dir: str) -> bool:
    return all(
        os.path.exists(os.path.join(data_dir, n))
        or os.path.exists(os.path.join(data_dir, n + ".gz"))
        for n in (TRAIN_IMAGES, TRAIN_LABELS, TEST_IMAGES, TEST_LABELS))


def load_datasets(data_dir: str = "MNIST_data", dataset: str = "auto",
                  seed: int = 0, synthetic_train_size: int = 55000,
                  synthetic_test_size: int = 10000,
                  input_size: int = 784) -> Dataset:
    """``mnist``: the IDX files in ``data_dir`` (refused when absent: the
    port does not download); ``auto``: those files when present, else
    the synthetic data; ``synthetic``: the synthetic data.  A width
    other than 784 needs the synthetic data."""
    from ..config import Unported

    if input_size != 784:
        if dataset == "mnist" or (dataset == "auto"
                                  and idx_files_present(data_dir)):
            raise ValueError(
                f"input_size={input_size}: real MNIST IDX data is "
                f"784-dim; use --dataset=synthetic for non-MNIST-shaped "
                f"configs")
        dataset = "synthetic"
    if dataset in ("mnist", "auto") and idx_files_present(data_dir):
        return load_idx_dataset(data_dir)
    if dataset == "mnist":
        raise Unported(
            f"MNIST IDX files not found in {data_dir!r}, and the MNIST "
            f"download is not ported to the PyTorch trainer yet (see "
            f"ROADMAP.md Queue A): drop {TRAIN_IMAGES}, {TRAIN_LABELS}, "
            f"{TEST_IMAGES}, {TEST_LABELS} (optionally .gz) there, or "
            f"use --dataset=synthetic")
    return synthesize_dataset(seed=seed, train_size=synthetic_train_size,
                              test_size=synthetic_test_size,
                              input_size=input_size)


# ---------------------------------------------------------------------------
# Epoch iterator (next_batch)
# ---------------------------------------------------------------------------


class EpochIterator:
    """Shuffled mini-batches, one permutation per epoch.  Sharded,
    process ``p`` of ``P`` walks the permutation's slice ``p::P``,
    truncated to ``floor(N / P)`` so every process runs the same
    number of (collective) steps; unsharded, every process walks the
    whole permutation (the reference's own behaviour)."""

    def __init__(self, split: DataSplit, batch_size: int, seed: int = 1,
                 shard: bool = True, process_index: int = 0,
                 process_count: int = 1):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.split = split
        self.batch_size = batch_size
        self.shard = shard
        self.process_index = process_index
        self.process_count = process_count
        self._seed = seed
        self._epoch = 0

    def _local_examples(self) -> int:
        n = self.split.num_examples
        if self.shard:
            n = n // self.process_count
        return n

    @property
    def batches_per_epoch(self) -> int:
        """Whole batches only: the remainder of an epoch is dropped."""
        return self._local_examples() // self.batch_size

    def batch_indices(self, epoch_index: int | None = None
                      ) -> List[np.ndarray]:
        """The example indices of each batch of one shuffled pass, keyed
        by ``(seed, epoch_index)`` (default: an internal counter)."""
        if epoch_index is None:
            epoch_index = self._epoch
        rng = np.random.RandomState([self._seed & 0x7FFFFFFF, epoch_index])
        perm = rng.permutation(self.split.num_examples)
        self._epoch = epoch_index + 1
        if self.shard and self.process_count > 1:
            perm = perm[self.process_index:: self.process_count]
            perm = perm[: self._local_examples()]
        return [perm[b * self.batch_size: (b + 1) * self.batch_size]
                for b in range(self.batches_per_epoch)]

    def epoch(self, epoch_index: int | None = None
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One shuffled pass (``batch_indices``) as numpy batches.  The
        permutation is drawn at this call, not at the first ``next``."""
        batches = self.batch_indices(epoch_index)
        return ((self.split.images[idx], self.split.labels[idx])
                for idx in batches)
