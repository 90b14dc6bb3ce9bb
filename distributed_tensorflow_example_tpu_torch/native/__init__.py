"""ctypes bindings for the port's native host-runtime library: its copy
of the JAX package's ``native/__init__.py``.

Host-side work the reference delegated to TensorFlow's C++ runtime: CRC32C
for TFRecord-framed TensorBoard event files (``crc32c``,
``masked_crc32c``, which ``utils/summary`` frames every record with),
and JAX's IDX pixel decode (``u8_to_f32_scaled``) and mini-batch gather
(``gather_batch``).  The port keeps the last two for the JAX package's C
ABI and results, and calls neither: its IDX loader divides as JAX's
does, and its host path indexes with numpy, which measured faster than
the library's gather for a 100-row batch (PERF.md).  It is not a kernel
of the card: the card's kernels are the CUDA sources under ``ops/csrc``.

The shared library is built with ``g++ -O3 -shared -fPIC`` at first use
into ``build/native/`` at the repo root (a directory ``.gitignore``
lists, beside ``ops/_build.py``'s ``build/kernels/``), named by the
source's hash and published atomically, and loaded with ``ctypes``.
Every function has a numpy / Python fallback, so the package runs
(slower) without a compiler; ``DTX_NO_NATIVE=1`` forces the fallback.
The results are bit for bit the JAX package's, built or not
(``u8_to_f32_scaled``'s library form multiplies by ``1/255`` where the
fallback divides, as JAX's do: up to one ulp apart).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "dtx_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_load_attempted = False


def library_path() -> Path:
    """Where the library for the current source lives once built."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdtx_native-{digest[:16]}.so"


def _build(out: Path) -> bool:
    """Compile the source into ``out`` (through a temp file in the same
    directory, then ``os.replace``: a concurrent build sees a whole
    library or none).  False when there is no compiler or it fails."""
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_lib = Path(tmp) / out.name
            subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp_lib), str(SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp_lib, out)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def _open() -> "ctypes.CDLL | None":
    """Build (when absent) and load the library, its signatures set."""
    try:
        path = library_path()
    except OSError:
        return None
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    # arrays pass as their data addresses (c_void_p): the same C ABI as
    # typed pointers, without building a ctypes pointer object per
    # argument (which cost more than the copy of a 100-row batch)
    ptr = ctypes.c_void_p
    lib.dtx_crc32c.restype = ctypes.c_uint32
    lib.dtx_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.dtx_u8_to_f32_scaled.restype = None
    lib.dtx_u8_to_f32_scaled.argtypes = [ptr, ctypes.c_size_t, ptr]
    lib.dtx_gather_batch.restype = None
    lib.dtx_gather_batch.argtypes = [
        ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ptr,
        ptr]
    return lib


def _load() -> "ctypes.CDLL | None":
    """The library, or None (no compiler, or ``DTX_NO_NATIVE``).  The
    first call builds and loads it under the lock; ``_lib`` is set
    before ``_load_attempted``, so later calls read both unlocked."""
    global _lib, _load_attempted
    if os.environ.get("DTX_NO_NATIVE"):
        return None
    if _load_attempted:
        return _lib
    with _lock:
        if not _load_attempted:
            _lib = _open()
            _load_attempted = True
        return _lib


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, polynomial 0x82F63B78)
# ---------------------------------------------------------------------------


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def py_crc32c(data: bytes) -> int:
    """The table-driven Python CRC32C: the fallback, and the reference
    the library is held to."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    lib = _load()
    if lib is not None:
        return lib.dtx_crc32c(data, len(data))
    return py_crc32c(data)


def masked_crc32c(data: bytes) -> int:
    """TFRecord CRC masking (the RecordWriter convention)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# IDX pixel decode
# ---------------------------------------------------------------------------


def u8_to_f32_scaled(arr: np.ndarray) -> np.ndarray:
    """uint8 pixels -> float32 in [0, 1]."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return arr.astype(np.float32) / 255.0
    out = np.empty(arr.shape, dtype=np.float32)
    lib.dtx_u8_to_f32_scaled(arr.ctypes.data, arr.size, out.ctypes.data)
    return out


# ---------------------------------------------------------------------------
# Batch gather
# ---------------------------------------------------------------------------


def _gatherable(a: np.ndarray) -> bool:
    return (isinstance(a, np.ndarray) and a.dtype == np.float32
            and a.ndim == 2 and a.flags.c_contiguous)


def gather_batch(images: np.ndarray, labels: np.ndarray, idx: np.ndarray):
    """``(images[idx], labels[idx])`` in the library (JAX's host-path
    batch gather; the port's host path indexes with numpy).  Arrays the
    library cannot take (not C-contiguous 2-D float32, rows disagreeing) and indices
    outside ``[0, rows)`` go through numpy's indexing, which gives the
    same result or raises its own error."""
    lib = _load()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if (lib is None or not _gatherable(images) or not _gatherable(labels)
            or images.shape[0] != labels.shape[0] or idx.ndim != 1
            or (idx.size and (idx.min() < 0
                              or idx.max() >= images.shape[0]))):
        return images[idx], labels[idx]
    n = idx.shape[0]
    out_img = np.empty((n, images.shape[1]), dtype=np.float32)
    out_lbl = np.empty((n, labels.shape[1]), dtype=np.float32)
    lib.dtx_gather_batch(
        images.ctypes.data, labels.ctypes.data, idx.ctypes.data, n,
        images.shape[1], labels.shape[1], out_img.ctypes.data,
        out_lbl.ctypes.data)
    return out_img, out_lbl
