"""MNIST IDX download with mirror fallback and SHA-256 verification: the
port's copy of the JAX package's ``data/download.py``.

``--dataset=mnist`` with the IDX files absent from ``--data_dir``
downloads the four canonical archives, as the reference's
``input_data.read_data_sets('MNIST_data', one_hot=True)`` did:

- a **mirror list** (``--mnist_mirrors`` overrides it), tried in order
  per file;
- **SHA-256 verification** of every downloaded archive against the
  published digests: a truncated or tampered file is discarded and the
  next mirror is tried;
- **resume-safe writes**: downloads land in a same-directory temp file
  and are atomically ``os.replace``d into place only after the digest
  checks out, so a killed process never leaves a corrupt file where the
  loader would trust it; abandoned temps of killed runs are reaped.

Every failure path raises ``DownloadError`` listing what was tried;
``data.mnist.load_datasets`` surfaces it next to the
drop-the-files-in-place instructions.  The tests drive this module
against a local ``http.server`` fixture, so nothing is fetched from
outside the machine.
"""

from __future__ import annotations

import hashlib
import os
import urllib.error
import urllib.request

# Canonical gzip archives and their published SHA-256 digests.
MNIST_FILES = {
    "train-images-idx3-ubyte.gz":
        "440fcabf73cc546fa21475e81ea370265605f56be210a4024d2ca8f203523609",
    "train-labels-idx1-ubyte.gz":
        "3552534a0a558bbed6aed32b30c495cca23d567ec52cac8be1a0730e8010255c",
    "t10k-images-idx3-ubyte.gz":
        "8d422c7b0a1c1c79245a5bcf07fe86e33eeafee792b84584aec276f5a2dbc4e6",
    "t10k-labels-idx1-ubyte.gz":
        "f7ae60f92e00ec6debd23a6088c31dbd2371eca3ffa0defaefb259924204aec6",
}

MIRRORS = (
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
    "http://yann.lecun.com/exdb/mnist/",
)

_CHUNK = 1 << 16


class DownloadError(RuntimeError):
    pass


def _reap_stale_temps(dest: str, max_age_s: float = 3600.0) -> None:
    """Remove abandoned ``<dest>.tmp-<pid>`` files from killed runs.
    Age-gated so a concurrent process's in-flight download (writing its
    own pid-suffixed temp right now) is left alone."""
    import glob
    import time

    for tmp in glob.glob(dest + ".tmp-*"):
        try:
            if time.time() - os.path.getmtime(tmp) > max_age_s:
                os.remove(tmp)
        except OSError:
            pass  # raced with its owner; harmless


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _fetch_one(url: str, dest: str, sha256: str | None, timeout: float) -> None:
    """Stream url -> dest via a same-directory temp file; verify digest
    before the atomic rename. Raises on any failure, leaving no partial
    file at ``dest``."""
    tmp = f"{dest}.tmp-{os.getpid()}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, \
                open(tmp, "wb") as out:
            while True:
                chunk = resp.read(_CHUNK)
                if not chunk:
                    break
                out.write(chunk)
        if sha256 is not None:
            got = sha256_file(tmp)
            if got != sha256:
                raise DownloadError(
                    f"{url}: SHA-256 mismatch (got {got}, want {sha256})"
                )
        os.replace(tmp, dest)  # atomic: readers never see a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def download_file(
    name: str,
    data_dir: str,
    mirrors=None,
    sha256: str | None = None,
    timeout: float = 30.0,
) -> str:
    """Fetch ``name`` into ``data_dir``, trying each mirror in order.
    Returns the local path; no-op if a file with the right digest is
    already in place."""
    if mirrors is None:
        mirrors = MIRRORS  # resolved at call time (tests patch the module)
    os.makedirs(data_dir, exist_ok=True)
    dest = os.path.join(data_dir, name)
    _reap_stale_temps(dest)  # before the early-return: a completed file
    # can coexist with another process's abandoned temp
    if os.path.exists(dest) and (sha256 is None or sha256_file(dest) == sha256):
        return dest
    errors = []
    for base in mirrors:
        url = base.rstrip("/") + "/" + name  # tolerate no trailing slash
        # visible per-attempt line: on silently-dropping networks each
        # attempt can run to its timeout, and this must not look like a
        # hang (read_data_sets printed progress too)
        print(f"Downloading {url} ...", flush=True)
        try:
            _fetch_one(url, dest, sha256, timeout)
            return dest
        except (urllib.error.URLError, OSError, DownloadError) as e:
            errors.append(f"  {url}: {e}")
    raise DownloadError(
        f"could not download {name!r}; tried:\n" + "\n".join(errors)
    )


def download_mnist(
    data_dir: str = "MNIST_data", mirrors=None, timeout: float = 10.0
) -> None:
    """Fetch all four MNIST archives (the read_data_sets behavior,
    example.py:47-48), verifying each against its published SHA-256."""
    for name, digest in MNIST_FILES.items():  # module global: patchable
        download_file(name, data_dir, mirrors=mirrors, sha256=digest,
                      timeout=timeout)
