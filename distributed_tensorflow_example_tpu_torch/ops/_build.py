"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

The sources have a plain C interface.  ``nvcc`` compiles each one for
Hopper (``sm_90a``) into an object — all of them at once, one process
each — and links the objects into one shared library under
``build/kernels/`` at the repo root (a directory ``.gitignore``
lists), named by a hash of the sources so an edited source rebuilds.
``ctypes`` loads it; the wrappers in ``ops/fused.py`` and
``ops/flash_attention.py`` pass pointers and the current stream as
integers.

Nothing here runs at import: the first wrapper call on a CUDA tensor
builds and loads the library.  A build that fails raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of every C entry point the wrappers call
SIGNATURES = {
    # x, g, b, y, rows, d, dtype, stream
    "dtx_layer_norm_fwd": (_P, _P, _P, _P, _I, _I, _I, _P),
    # x, r, g, b, y, s, rows, d, dtype, stream
    "dtx_layer_norm_residual_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "dtx_layer_norm_max_d": (),
    "dtx_layer_norm_reg_max_d": (),
    # dy, x, g, dx, part, dg, db, rows, d, ctas, dtype, stream
    "dtx_layer_norm_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "dtx_layer_norm_bwd_max_ctas": (),
    # x, w1, b1, w2, b2, h1, out, z1 (NULL = the primal form), part
    # (NULL = no split), E, C, d, ff, act, dtype, halves1, splits1,
    # halves2, splits2, stream
    "dtx_grouped_ffn_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # A, W, bias, out, M, N, K, act, dtype, last, stream
    "dtx_mlp_layer_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, o, acc, m, l, B, S, H, D, causal, stats, dtype, qscale,
    # stream
    "dtx_flash_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _F, _P),
    # q, k, v, do, m, l, dlt, dq, B, S, H, D, causal, dtype, qscale,
    # scale, stream
    "dtx_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _F, _F, _P),
    # q, k, v, do, m, l, dlt, dk, dv, B, S, H, D, causal, dtype, qscale,
    # inv_log2e, stream
    "dtx_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _I, _F, _F, _P),
    "dtx_flash_max_d": (),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, compiler output
last_build: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from ops/csrc at first use on the card")
    return found


def build() -> Path:
    """Compile every source (in parallel) and link the library; returns
    its path.  An existing library for the same source hash is reused.
    The compiler output, with ``-Xptxas -v``'s registers, shared memory
    and spills per kernel, is kept beside the library (``.log``) and in
    ``last_build`` (``seconds`` is None for a library that was reused)."""
    out = BUILD_DIR / f"libdtx_torch_kernels-{_digest()}.so"
    log_file = out.with_suffix(".log")
    if out.exists():
        if last_build.get("path") != str(out):   # not built by this process
            last_build.update(seconds=None, path=str(out), log=(
                log_file.read_text() if log_file.exists() else ""))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    extra = ("-Xptxas", "-v")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [cc, *ARCH_FLAGS, *NVCC_FLAGS, *extra, "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _obj, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [cc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(o) for _s, o, _p in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        tmp_log = Path(tmp) / log_file.name
        tmp_log.write_text("\n".join(log))
        # atomic publish: a concurrent build sees a whole file or none
        os.replace(tmp_log, log_file)
        os.replace(tmp_lib, out)
    last_build.update(seconds=time.monotonic() - t0, log="\n".join(log),
                      path=str(out))
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
