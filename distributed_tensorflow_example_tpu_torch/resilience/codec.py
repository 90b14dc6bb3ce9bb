"""Tensor <-> on-disk payload codec shared by every checkpoint format
(the port's copy of the JAX package's ``resilience/codec.py``).

``np.save`` / ``np.savez`` cannot hold bf16 or the fp8 types, so such
leaves persist as their same-width unsigned-int bit containers beside
the recorded dtype name ("bfloat16", "float8_e4m3fn", ...), and readers
view the bits back.  The names and containers are the JAX package's, so
a payload either package writes decodes in the other.  One codec serves
the classic formats (``utils/checkpoint.py``) and the resilience store
(``resilience/manifest.py``).  Payloads are numpy arrays; decoded leaves
are CPU tensors (numpy has no bf16 without ml_dtypes, and the port does
not need it).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

# the torch dtypes numpy cannot hold, by the name numpy (ml_dtypes)
# gives them
_BIT_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_BIT_NAMES = {v: k for k, v in _BIT_DTYPES.items()}

Leaf = Union[torch.Tensor, np.ndarray]


def dtype_name(a: Leaf) -> str:
    """The numpy name of a leaf's dtype ("float32", "bfloat16", ...),
    the name the manifests record."""
    if isinstance(a, torch.Tensor):
        if a.dtype in _BIT_NAMES:
            return _BIT_NAMES[a.dtype]
        return str(a.dtype).replace("torch.", "")
    return np.asarray(a).dtype.name


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a recorded numpy dtype name."""
    if name in _BIT_DTYPES:
        return _BIT_DTYPES[name]
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


def bit_container_dtype(name: str) -> Optional[np.dtype]:
    """The same-width unsigned-int container of a dtype numpy's savers
    cannot hold, or None for a native one."""
    if name in _BIT_DTYPES:
        return np.dtype(f"u{torch.finfo(_BIT_DTYPES[name]).bits // 8}")
    dt = np.dtype(name)
    if dt.kind in "biufcSU":
        return None
    return np.dtype(f"u{dt.itemsize}")


def encode_array(a: Leaf) -> Tuple[np.ndarray, Optional[str]]:
    """(savable numpy array, the dtype name when bit-encoded) of a host
    tensor or array."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype in _BIT_NAMES:
            bits = bit_container_dtype(_BIT_NAMES[t.dtype])
            as_int = torch.int16 if bits.itemsize == 2 else torch.uint8
            return (t.contiguous().view(as_int).numpy().view(bits),
                    _BIT_NAMES[t.dtype])
        return t.numpy(), None
    a = np.asarray(a)
    bits = bit_container_dtype(a.dtype.name)
    return (a.view(bits), a.dtype.name) if bits is not None else (a, None)


def decode_array(a: np.ndarray, name: Optional[str] = None) -> torch.Tensor:
    """A payload array as a CPU tensor: a bit container viewed back as
    the recorded dtype ``name``, a native array as itself (copied, so
    the tensor owns writable memory)."""
    a = np.array(a)
    if name in _BIT_DTYPES:
        bits = bit_container_dtype(name)
        as_int = np.int16 if bits.itemsize == 2 else np.uint8
        return torch.from_numpy(a.view(as_int)).view(_BIT_DTYPES[name])
    if name is not None:
        a = a.view(np.dtype(name))
    if a.dtype.kind not in "biufc":
        # an ml_dtypes array the reader holds natively
        return decode_array(a.view(bit_container_dtype(a.dtype.name)),
                            a.dtype.name)
    return torch.from_numpy(a)


__all__ = ["dtype_name", "torch_dtype", "bit_container_dtype",
           "encode_array", "decode_array"]
