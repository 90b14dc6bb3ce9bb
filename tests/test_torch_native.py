"""The port's ``native`` (its copy of the JAX package's C++ host helper)
against JAX's ``native`` on seeded inputs, bit for bit: ``crc32c``,
``masked_crc32c``, ``u8_to_f32_scaled`` and ``gather_batch``, both with
the libraries built and under ``DTX_NO_NATIVE=1`` (the numpy / Python
fallbacks); plus where the port builds its library and its callers."""

import os

import numpy as np
import pytest

from distributed_tensorflow_example_tpu import native as jnative
from distributed_tensorflow_example_tpu_torch import native as tnative


@pytest.fixture(params=["built", "fallback"])
def mode(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setenv("DTX_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("DTX_NO_NATIVE", raising=False)
        if not (tnative.native_available() and jnative.native_available()):
            pytest.skip("no C++ compiler: only the fallbacks can run")
    return request.param


def _buffers():
    rng = np.random.RandomState(23)
    return [b"", b"a", b"123456789", rng.bytes(7), rng.bytes(4096 + 5),
            bytes(range(256)) * 3]


def test_crc32c_check_value_and_equal_to_jax(mode):
    assert tnative.crc32c(b"123456789") == 0xE3069283
    for buf in _buffers():
        assert tnative.crc32c(buf) == jnative.crc32c(buf)
        assert tnative.masked_crc32c(buf) == jnative.masked_crc32c(buf)
        assert tnative.crc32c(buf) == tnative.py_crc32c(buf)


def test_u8_to_f32_scaled_bitwise_jax(mode):
    rng = np.random.RandomState(5)
    for shape in ((256,), (7, 28, 28), (0, 784)):
        arr = rng.randint(0, 256, size=shape).astype(np.uint8)
        if arr.size >= 256:
            arr.reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
        got, want = tnative.u8_to_f32_scaled(arr), \
            jnative.u8_to_f32_scaled(arr)
        assert got.dtype == np.float32 and got.shape == arr.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # the library multiplies by 1/255 where numpy divides (as JAX's):
    # never more than one ulp apart
    every = np.arange(256, dtype=np.uint8)
    diff = (tnative.u8_to_f32_scaled(every).view(np.int32).astype(np.int64)
            - (every.astype(np.float32) / 255.0).view(np.int32))
    assert np.abs(diff).max() <= (1 if mode == "built" else 0)


def test_gather_batch_bitwise_jax_and_numpy(mode):
    rng = np.random.RandomState(11)
    images = rng.rand(97, 784).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 97)]
    for idx in (rng.permutation(97)[:32], np.array([96, 0, 0, 5]),
                np.zeros(0, dtype=np.int64), rng.randint(0, 97, 13)):
        gi, gl = tnative.gather_batch(images, labels, idx)
        ji, jl = jnative.gather_batch(images, labels, idx)
        for got, want, ref in ((gi, ji, images[idx]), (gl, jl, labels[idx])):
            assert got.dtype == np.float32
            assert np.array_equal(got, want) and np.array_equal(got, ref)


def test_gather_batch_takes_numpy_for_what_the_library_cannot(mode):
    """Non-contiguous or non-f32 arrays and negative indices are numpy's
    indexing (same answer), out-of-range ones numpy's IndexError."""
    rng = np.random.RandomState(3)
    images = rng.rand(20, 16).astype(np.float32)
    labels = rng.rand(20, 4).astype(np.float32)
    idx = np.array([3, -1, 7])
    for imgs in (images, images[:, ::2], images.astype(np.float64)):
        gi, gl = tnative.gather_batch(imgs, labels, idx)
        assert np.array_equal(gi, imgs[idx])
        assert np.array_equal(gl, labels[idx])
    with pytest.raises(IndexError):
        tnative.gather_batch(images, labels, np.array([20]))


def test_library_builds_into_build_native_beside_kernels():
    """Named by the source's hash under build/native/ at the repo root
    (gitignored), never next to the source."""
    path = tnative.library_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(path.parent) == os.path.join(repo, "build", "native")
    assert path.name.startswith("libdtx_native-")
    assert not any(p.suffix == ".so" for p in tnative.SRC.parent.parent
                   .iterdir())


def test_fallback_env_switch(monkeypatch):
    monkeypatch.setenv("DTX_NO_NATIVE", "1")
    assert tnative.native_available() is False
    assert tnative.crc32c(b"123456789") == 0xE3069283


def test_summary_frames_records_with_the_native_crc(tmp_path):
    """The event file's record CRCs come from ``native``: a written file
    reads back, and its first record's length CRC is
    ``masked_crc32c`` of its header, as JAX's writer frames it."""
    import struct

    from distributed_tensorflow_example_tpu_torch.utils import summary

    w = summary.SummaryWriter(str(tmp_path))
    w.add_scalars(1, {"cost": 0.5})
    w.close()
    [path] = [p for p in tmp_path.iterdir() if "tfevents" in p.name]
    blob = path.read_bytes()
    assert struct.unpack("<I", blob[8:12])[0] == \
        jnative.masked_crc32c(blob[:8])
    events = list(summary.read_event_file(str(path)))
    assert len(events) == 2
