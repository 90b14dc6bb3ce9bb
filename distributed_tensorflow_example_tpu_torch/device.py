"""Device selection: the port runs on the card unless asked otherwise.

Every entry point takes a ``device`` argument and resolves it here.
``None`` means ``cuda``; a CPU run must be asked for by name
(``device="cpu"`` in the tests, ``--device cpu`` on the command line).
When ``cuda`` is asked for on a machine with no card this raises: the
port never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (None -> ``cuda``); raises
    RuntimeError when a CUDA device is asked for and none exists, and
    ValueError for a device type the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {dev}: expected 'cuda' or 'cpu'")
    return dev


def dtype_from_name(name: Optional[str]) -> torch.dtype:
    """``"float32"``/``"bfloat16"``/... -> the torch dtype (the flag
    spelling the JAX package's config uses)."""
    aliases = {"float32": torch.float32, "f32": torch.float32,
               "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
               "float16": torch.float16, "f16": torch.float16}
    try:
        return aliases[str(name)]
    except KeyError:
        raise ValueError(f"dtype {name!r}: expected one of "
                         f"{sorted(aliases)}") from None
