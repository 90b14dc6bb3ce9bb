"""The port's MNIST download (``data/download.py``) and
``load_datasets``' download branch, against a local ``http.server``
fixture (nothing leaves the machine): the port's form of
``tests/test_download.py`` (mirror fallback, SHA-256 rejection of a
corrupt payload, atomic writes, stale temps, the ``--dataset=mnist``
fetch and parse), the port's ``load_datasets`` equal to JAX's on the
same files, and two gloo ranks of which only rank 0 fetches (one request
per file at the fixture) while both load bitwise-equal arrays, as
``tests/test_download_multiprocess.py`` holds JAX's."""

import gzip
import hashlib
import http.server
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from distributed_tensorflow_example_tpu.data import download as JD
from distributed_tensorflow_example_tpu.data import mnist as JM
from distributed_tensorflow_example_tpu_torch.data import download as D
from distributed_tensorflow_example_tpu_torch.data import mnist as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_mnist_archives():
    """Four tiny-but-valid gzipped IDX files (8 train / 4 test images)."""
    rng = np.random.RandomState(0)

    def images(n):
        pix = rng.randint(0, 256, size=(n, 28, 28), dtype=np.uint8)
        return struct.pack(">IIII", M.IMAGE_MAGIC, n, 28, 28) + pix.tobytes()

    def labels(n):
        lab = rng.randint(0, 10, size=n).astype(np.uint8)
        return struct.pack(">II", M.LABEL_MAGIC, n) + lab.tobytes()

    return {
        M.TRAIN_IMAGES + ".gz": gzip.compress(images(8), mtime=0),
        M.TRAIN_LABELS + ".gz": gzip.compress(labels(8), mtime=0),
        M.TEST_IMAGES + ".gz": gzip.compress(images(4), mtime=0),
        M.TEST_LABELS + ".gz": gzip.compress(labels(4), mtime=0),
    }


class _Handler(http.server.BaseHTTPRequestHandler):
    files: dict = {}
    hits: list = []

    def do_GET(self):
        name = self.path.rsplit("/", 1)[-1]
        type(self).hits.append(name)
        payload = self.files.get(name)
        if payload is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *a):  # quiet
        pass


def _serve(files):
    handler = type("H", (_Handler,), {"files": files, "hits": []})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, handler, f"http://127.0.0.1:{srv.server_address[1]}/mnist/"


@pytest.fixture()
def http_mirror():
    """(base_url, files_dict, hits_list)."""
    files = _tiny_mnist_archives()
    srv, handler, base = _serve(files)
    try:
        yield base, files, handler.hits
    finally:
        srv.shutdown()
        srv.server_close()


def _digests(files):
    return {k: hashlib.sha256(v).hexdigest() for k, v in files.items()}


def test_download_fetches_and_verifies(http_mirror, tmp_path):
    base, files, _ = http_mirror
    for name, digest in _digests(files).items():
        path = D.download_file(name, str(tmp_path), mirrors=(base,),
                               sha256=digest)
        assert D.sha256_file(path) == digest == JD.sha256_file(path)
    assert not [p for p in os.listdir(tmp_path) if ".tmp-" in p]


def test_corrupt_payload_rejected_then_next_mirror_used(http_mirror,
                                                        tmp_path):
    base, files, _ = http_mirror
    name = M.TRAIN_IMAGES + ".gz"
    digest = hashlib.sha256(files[name]).hexdigest()
    bad = dict(files)
    bad[name] = files[name][:-4] + b"XXXX"
    bad_srv, bad_handler, bad_base = _serve(bad)
    try:
        path = D.download_file(name, str(tmp_path),
                               mirrors=(bad_base, base), sha256=digest)
        assert D.sha256_file(path) == digest
        assert bad_handler.hits == [name]   # the corrupt mirror first
    finally:
        bad_srv.shutdown()
        bad_srv.server_close()


def test_all_mirrors_bad_raises_with_detail(http_mirror, tmp_path):
    base, _files, _ = http_mirror
    name = M.TRAIN_LABELS + ".gz"
    with pytest.raises(D.DownloadError, match="SHA-256 mismatch"):
        D.download_file(name, str(tmp_path), mirrors=(base,),
                        sha256="0" * 64)
    assert not os.path.exists(tmp_path / name)


def test_existing_verified_file_not_refetched(http_mirror, tmp_path):
    base, files, hits = http_mirror
    name = M.TEST_LABELS + ".gz"
    digest = hashlib.sha256(files[name]).hexdigest()
    D.download_file(name, str(tmp_path), mirrors=(base,), sha256=digest)
    n_hits = len(hits)
    D.download_file(name, str(tmp_path), mirrors=(base,), sha256=digest)
    assert len(hits) == n_hits


def test_stale_temps_reaped_and_fresh_ones_left(http_mirror, tmp_path):
    """A killed run's temp (older than an hour) is removed; another
    process's in-flight temp (fresh) is left alone; our own is
    overwritten and cleaned."""
    base, files, _ = http_mirror
    name = M.TEST_IMAGES + ".gz"
    digest = hashlib.sha256(files[name]).hexdigest()
    old = tmp_path / f"{name}.tmp-999999"
    old.write_bytes(b"abandoned")
    os.utime(old, (time.time() - 7200, time.time() - 7200))
    fresh = tmp_path / f"{name}.tmp-999998"
    fresh.write_bytes(b"in flight")
    (tmp_path / f"{name}.tmp-{os.getpid()}").write_bytes(b"partial")
    path = D.download_file(name, str(tmp_path), mirrors=(base,),
                           sha256=digest)
    assert D.sha256_file(path) == digest
    assert sorted(p for p in os.listdir(tmp_path) if ".tmp-" in p) == \
        [fresh.name]


def test_dataset_mnist_downloads_end_to_end_equal_to_jax(http_mirror,
                                                         tmp_path,
                                                         monkeypatch):
    """--dataset=mnist with an empty data_dir fetches all four archives
    and parses them; the port's dataset equals JAX's on those files."""
    base, files, hits = http_mirror
    monkeypatch.setattr(D, "MNIST_FILES", _digests(files))
    monkeypatch.setattr(M, "VALIDATION_SIZE", 2)
    monkeypatch.setattr(JM, "VALIDATION_SIZE", 2)
    ds = M.load_datasets(str(tmp_path), dataset="mnist", mirrors=(base,))
    assert sorted(hits) == sorted(files)
    assert ds.source == "mnist"
    assert (ds.train.num_examples, ds.validation.num_examples,
            ds.test.num_examples) == (6, 2, 4)
    want = JM.load_datasets(str(tmp_path), dataset="mnist")
    for split in ("train", "validation", "test"):
        for arr in ("images", "labels"):
            assert np.array_equal(getattr(getattr(ds, split), arr),
                                  getattr(getattr(want, split), arr))
    # the default mirror list (patched) is taken when mirrors is empty
    monkeypatch.setattr(D, "MIRRORS", (base,))
    again = tmp_path / "again"
    assert M.load_datasets(str(again), dataset="mnist",
                           mirrors=()).source == "mnist"


def test_dataset_mnist_offline_raises_jax_error(tmp_path):
    unreachable = ("http://127.0.0.1:1/none/",)
    with pytest.raises(FileNotFoundError) as got:
        M.load_datasets(str(tmp_path / "nope"), dataset="mnist",
                        mirrors=unreachable)
    with pytest.raises(FileNotFoundError) as want:
        JM.load_datasets(str(tmp_path / "nope"), dataset="mnist",
                         mirrors=unreachable)
    assert str(got.value).split("\n")[0] == str(want.value).split("\n")[0]
    assert str(got.value).split("\n")[-1] == str(want.value).split("\n")[-1]


def test_auto_never_downloads(tmp_path):
    ds = M.load_datasets(str(tmp_path / "empty"), dataset="auto",
                         synthetic_train_size=20, synthetic_test_size=10,
                         mirrors=("http://127.0.0.1:1/",))
    assert ds.source == "synthetic"
    assert not os.path.exists(tmp_path / "empty")


def test_published_tables_are_jaxs():
    assert D.MNIST_FILES == JD.MNIST_FILES
    assert D.MIRRORS == JD.MIRRORS
    assert set(D.MNIST_FILES) == {M.TRAIN_IMAGES + ".gz",
                                  M.TRAIN_LABELS + ".gz",
                                  M.TEST_IMAGES + ".gz",
                                  M.TEST_LABELS + ".gz"}


# ---------------------------------------------------------------------------
# two gloo ranks: only rank 0 fetches
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
cfg = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
dist.init_process_group("gloo", init_method=cfg["coord"], world_size=2,
                        rank=rank)
from distributed_tensorflow_example_tpu_torch.data import download as D
from distributed_tensorflow_example_tpu_torch.data import mnist as M
D.MNIST_FILES = cfg["digests"]          # fixture archives, not canonical
M.VALIDATION_SIZE = 2
ds = M.load_datasets(cfg["data_dir"], dataset="mnist",
                     mirrors=tuple(cfg["mirrors"]))
# the files-present path joins the barrier too
again = M.load_datasets(cfg["data_dir"], dataset="mnist",
                        mirrors=tuple(cfg["mirrors"]))
assert ds.source == again.source == "mnist"
np.savez(cfg["out"] + f".{rank}.npz", images=ds.train.images,
         labels=ds.train.labels, test=ds.test.images)
dist.destroy_process_group()
print(f"rank {rank} ok")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_only_rank0_fetches(tmp_path):
    files = _tiny_mnist_archives()
    srv, handler, base = _serve(files)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "coord": f"tcp://127.0.0.1:{_free_port()}",
        "data_dir": str(tmp_path / "mnist"), "mirrors": [base],
        "digests": _digests(files), "out": str(tmp_path / "ds")}))
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    try:
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(cfg), str(r)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=180)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-3000:]
        assert "rank 0 ok" in outs[0] and "rank 1 ok" in outs[1]
    finally:
        srv.shutdown()
        srv.server_close()
    # one request per archive: the chief's; the other rank barriered
    assert sorted(handler.hits) == sorted(files)
    with np.load(f"{tmp_path / 'ds'}.0.npz") as a, \
            np.load(f"{tmp_path / 'ds'}.1.npz") as b:
        for k in ("images", "labels", "test"):
            assert np.array_equal(a[k], b[k]), k
        assert a["images"].shape == (6, 784)
