"""The port's input pipeline (``data/prefetch.py``), on the CPU: the
JAX package's prefetcher tests, ported — the host ``Prefetcher`` (same
batches, same order, errors propagate, post-close iteration fails fast),
the persistent ``EpochPrefetcher`` (one producer across epochs,
epoch-keyed rewind) and the ``DevicePrefetcher`` commit pipeline (depth
bounds, error propagation, early-exit close, epoch-persistent rewind),
all pure Python; then the port's own: ``CopyStreamCommit`` on the CPU,
``--device_prefetch`` bit-exact with the blocking host path through
``run``, and the three host-path flags parsed with the JAX trainer's
defaults and checks.  The pinned, copy-stream commit on the card is
held to the blocking copies in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import itertools
import time

import numpy as np
import pytest

from distributed_tensorflow_example_tpu import config as jconfig
from distributed_tensorflow_example_tpu_torch import config as tconfig
from distributed_tensorflow_example_tpu_torch import main as tmain
from distributed_tensorflow_example_tpu_torch.data import (
    CopyStreamCommit, DevicePrefetcher, EpochIterator, EpochPrefetcher,
    Prefetcher, take)
from distributed_tensorflow_example_tpu_torch.data import mnist as M
from distributed_tensorflow_example_tpu_torch.train import loop as tloop
from distributed_tensorflow_example_tpu_torch.utils import checkpoint as tckpt


# --- Prefetcher (host stage) ----------------------------------------------


def test_prefetcher_preserves_batches():
    split = M.synthesize_split(100, seed=3)
    a = list(EpochIterator(split, batch_size=10, seed=1, shard=False).epoch())
    b = list(Prefetcher(EpochIterator(split, batch_size=10, seed=1, shard=False).epoch()))
    assert len(a) == len(b) == 10
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)


def test_prefetcher_propagates_errors():
    def gen():
        yield 1
        raise RuntimeError("boom")

    p = Prefetcher(gen())
    it = iter(p)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetcher_close_unblocks_producer():
    produced = []

    def gen():
        for i in itertools.count():
            produced.append(i)
            yield i

    p = Prefetcher(gen(), depth=2)
    it = iter(p)
    assert next(it) == 0
    p.close()
    p._thread.join(timeout=5)
    assert not p._thread.is_alive()
    # producer stopped promptly: queue depth 2 + in-flight item bound
    assert len(produced) < 10


def test_prefetcher_closed_iteration_raises():
    """Regression: close() drains the queue — including the end
    sentinel — so iterating a closed prefetcher used to hang forever
    on an empty queue. It must raise immediately instead."""
    p = Prefetcher(iter([1, 2, 3]))
    p.close()
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="closed"):
        iter(p)
    assert time.perf_counter() - t0 < 1.0  # fails fast, no hang

    # exhausting an iteration auto-closes (the finally); a second
    # iteration of the spent prefetcher must raise too, not hang
    p2 = Prefetcher(iter([1]))
    assert list(p2) == [1]
    with pytest.raises(RuntimeError, match="closed"):
        iter(p2)


def test_prefetcher_close_mid_iteration_raises_not_hangs():
    p = Prefetcher(iter(range(100)), depth=1)
    it = iter(p)
    assert next(it) == 0
    p.close()
    with pytest.raises(RuntimeError, match="closed"):
        # the queue was drained by close(): without the check this
        # next() would block forever waiting for a sentinel
        next(it)


# --- EpochPrefetcher (persistent producer, epoch-keyed rewind) ------------


def _epoch_fn(e):
    return iter([(e, i) for i in range(4)])


def test_epoch_prefetcher_one_producer_many_epochs():
    ep = EpochPrefetcher(_epoch_fn, range(3))
    thread = ep._thread
    for e in range(3):
        assert list(ep.epoch(e)) == [(e, i) for i in range(4)]
        assert ep._thread is thread  # the SAME producer, no respawn
    ep.close()


def test_epoch_prefetcher_matches_epoch_iterator():
    """The persistent producer yields exactly what per-epoch
    EpochIterator.epoch(e) calls would — epoch-keyed shuffles intact."""
    split = M.synthesize_split(40, seed=7)

    def mk():
        return EpochIterator(split, batch_size=10, seed=1, shard=False)

    ep = EpochPrefetcher(mk().epoch, range(2))
    ref = mk()
    for e in range(2):
        got = list(ep.epoch(e))
        want = list(ref.epoch(e))
        assert len(got) == len(want) == 4
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    ep.close()


def test_epoch_prefetcher_rewind_skips_abandoned_epoch():
    ep = EpochPrefetcher(_epoch_fn, range(5, 8))
    it = ep.epoch(5)
    assert next(it) == (5, 0)  # abandon epoch 5 mid-way
    assert list(ep.epoch(6)) == [(6, i) for i in range(4)]
    # the stream is forward-only: a consumed epoch cannot come back
    with pytest.raises(RuntimeError, match="forward-only"):
        list(ep.epoch(5))
    # an epoch outside the sequence is a hard error, not a hang
    with pytest.raises(RuntimeError, match="not in this prefetcher"):
        list(ep.epoch(42))
    ep.close()


def test_epoch_prefetcher_direct_iteration_rejected():
    """Direct iteration would interleave internal epoch markers with
    batches — the per-epoch surface is .epoch(e)."""
    ep = EpochPrefetcher(_epoch_fn, range(2))
    with pytest.raises(TypeError, match="epoch"):
        iter(ep)
    assert list(ep.epoch(0)) == [(0, i) for i in range(4)]
    ep.close()


def test_epoch_prefetcher_rejects_rerequest_of_started_epoch():
    """A partially-consumed epoch can never be handed out again: the
    remainder would be a silently truncated epoch, not 'exactly epoch
    e's batches'."""
    ep = EpochPrefetcher(_epoch_fn, range(2))
    it = ep.epoch(0)
    assert next(it) == (0, 0)
    with pytest.raises(RuntimeError, match="forward-only"):
        ep.epoch(0)
    assert list(ep.epoch(1)) == [(1, i) for i in range(4)]
    ep.close()


def test_epoch_prefetcher_propagates_producer_error():
    def bad_epoch(e):
        yield (e, 0)
        if e == 1:
            raise ValueError("gather failed")

    ep = EpochPrefetcher(bad_epoch, range(3))
    assert list(ep.epoch(0)) == [(0, 0)]
    it = ep.epoch(1)
    assert next(it) == (1, 0)
    with pytest.raises(ValueError, match="gather failed"):
        next(it)
    ep.close()


def test_epoch_prefetcher_close_then_epoch_raises():
    ep = EpochPrefetcher(_epoch_fn, range(2))
    assert list(ep.epoch(0)) == [(0, i) for i in range(4)]
    ep.close()
    ep._thread.join(timeout=5)
    assert not ep._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        next(ep.epoch(1))


# --- DevicePrefetcher (commit pipeline) -----------------------------------


class _CountingCommit:
    """Fake commit: tags batches and counts calls (the pure-python
    stand-in for device_put with the step sharding)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x, y):
        self.calls += 1
        return ("dev", x, y)


def test_device_prefetcher_commits_ahead_within_depth():
    commit = _CountingCommit()
    dp = DevicePrefetcher(commit, depth=3,
                          source=[(i, -i) for i in range(10)])
    consumed = 0
    for item in dp:
        consumed += 1
        # never more than `depth` commits ahead of consumption
        assert commit.calls - consumed <= 3
        assert item == ("dev", consumed - 1, -(consumed - 1))
    assert consumed == 10 and commit.calls == 10


def test_device_prefetcher_depth_validated():
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(lambda x, y: (x, y), depth=0)


def test_device_prefetcher_preserves_order_and_values():
    dp = DevicePrefetcher(lambda x, y: (x * 2, y * 2), depth=2,
                          source=[(i, i + 100) for i in range(7)])
    assert list(dp) == [(2 * i, 2 * (i + 100)) for i in range(7)]


def test_device_prefetcher_source_error_after_buffered_items():
    def src():
        yield (0, 0)
        yield (1, 1)
        raise RuntimeError("host gather died")

    dp = DevicePrefetcher(lambda x, y: (x, y), depth=4, source=src())
    it = iter(dp)
    assert next(it) == (0, 0)
    assert next(it) == (1, 1)  # committed batches drain first
    with pytest.raises(RuntimeError, match="host gather died"):
        next(it)


def test_device_prefetcher_commit_error_propagates():
    def bad_commit(x, y):
        if x == 2:
            raise ValueError("transfer failed")
        return (x, y)

    dp = DevicePrefetcher(bad_commit, depth=1, source=[(i, i) for i in range(4)])
    it = iter(dp)
    assert next(it) == (0, 0)
    assert next(it) == (1, 1)
    with pytest.raises(ValueError, match="transfer failed"):
        next(it)


def test_device_prefetcher_keyboard_interrupt_not_deferred():
    """_fill runs on the consumer thread: a KeyboardInterrupt from the
    source must stop the run NOW, not surface `depth` batches later
    disguised as a data-pipeline failure."""
    def src():
        yield (0, 0)
        raise KeyboardInterrupt

    dp = DevicePrefetcher(lambda x, y: (x, y), depth=4, source=src())
    with pytest.raises(KeyboardInterrupt):
        next(iter(dp))  # raised before the buffered batch is served


def test_device_prefetcher_early_exit_close():
    commit = _CountingCommit()
    dp = DevicePrefetcher(commit, depth=2,
                          source=[(i, i) for i in range(100)])
    it = iter(dp)
    next(it)
    dp.close()
    assert dp.closed and len(dp._buf) == 0  # buffers released
    with pytest.raises(RuntimeError, match="closed"):
        iter(dp)
    with pytest.raises(RuntimeError, match="closed"):
        next(it)
    with pytest.raises(RuntimeError, match="closed"):
        dp.rewind([(0, 0)])
    before = commit.calls
    time.sleep(0.01)
    assert commit.calls == before  # nothing commits after close


def test_device_prefetcher_epoch_persistent_rewind():
    """ONE instance spans epochs: rewind() re-arms it on the next
    epoch's source, dropping the old epoch's buffered commits and
    clearing a pending source error."""
    commit = _CountingCommit()
    dp = DevicePrefetcher(commit, depth=3)

    # a fresh instance with no source is simply empty
    assert list(dp) == []

    dp.rewind([(0, i) for i in range(5)])
    it = iter(dp)
    assert next(it) == ("dev", 0, 0)  # epoch 0 abandoned mid-way

    dp.rewind([(1, i) for i in range(3)])
    assert list(dp) == [("dev", 1, i) for i in range(3)]

    # rewind clears a pending error from the previous source
    def bad():
        raise RuntimeError("boom")
        yield  # pragma: no cover

    dp.rewind(bad())
    with pytest.raises(RuntimeError, match="boom"):
        list(dp)
    dp.rewind([(2, 0)])
    assert list(dp) == [("dev", 2, 0)]


def test_device_prefetcher_over_epoch_prefetcher():
    """The composition the train loop runs: EpochPrefetcher feeds a
    persistent DevicePrefetcher, rewound per epoch."""
    commit = _CountingCommit()
    ep = EpochPrefetcher(_epoch_fn, range(2))
    dp = DevicePrefetcher(commit, depth=2)
    out = []
    for e in range(2):
        out.append(list(dp.rewind(ep.epoch(e))))
    dp.close()
    ep.close()
    assert out == [[("dev", e, i) for i in range(4)] for e in range(2)]
    assert commit.calls == 8


# --- the port's own ------------------------------------------------------


def test_copy_stream_commit_on_the_cpu_wraps_the_arrays():
    """On the CPU the commit wraps the numpy batch without a copy and
    carries no event; ``take`` hands it back unchanged."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    y = np.eye(3, dtype=np.float32)
    dx, dy, ready = CopyStreamCommit("cpu")(x, y)
    assert ready is None and dx.device.type == "cpu"
    assert np.shares_memory(dx.numpy(), x)
    tx, ty = take(dx, dy, ready)
    assert tx is dx and ty is dy


@pytest.mark.parametrize("depth", [1, 3])
def test_device_prefetch_bit_exact_with_blocking_copy(tmp_path, depth):
    """The host path's run under ``--device_prefetch`` (at two depths)
    against the blocking copy, same seed: identical printed costs, test
    accuracy and steps, and bit-identical final params and slots (via
    the checkpoint), with summaries written from the per-window
    fetches."""
    base = tconfig.Config(batch_size=32, dataset="synthetic",
                          synthetic_train_size=32 * 6,
                          synthetic_test_size=64, training_epochs=2,
                          fast_loop=False, frequency=2, hidden_sizes=(16,),
                          optimizer="momentum", learning_rate=0.1,
                          device="cpu")
    results, params = {}, {}
    for name, dev in (("blocking", False), ("prefetched", True)):
        cdir = tmp_path / f"ckpt_{name}"
        results[name] = tloop.run(dataclasses.replace(
            base, device_prefetch=dev, prefetch_depth=depth,
            checkpoint_dir=str(cdir), logs_path=str(tmp_path / name)))
        params[name] = np.load(tckpt.latest_checkpoint(str(cdir)),
                               allow_pickle=False)
    rb, rp = results["blocking"], results["prefetched"]
    assert rb["fast_loop"] is rp["fast_loop"] is False
    for k in ("final_cost", "test_accuracy", "steps"):
        assert rb[k] == rp[k], k
    a, b = params["blocking"], params["prefetched"]
    assert a.files == b.files and len(a.files) > 0
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_host_path_flags_parse_with_the_jax_defaults():
    """``--device_prefetch``, ``--prefetch_depth`` and
    ``--dispatch_depth``: the JAX trainer's names and defaults (0 = the
    device's default), and explicit values parse alike."""
    d, jd = tconfig.parse_train_config([]), jconfig.Config()
    for k in ("device_prefetch", "prefetch_depth", "dispatch_depth"):
        assert getattr(d, k) == getattr(jd, k), k
    argv = ["--device_prefetch", "--prefetch_depth=3", "--dispatch_depth=5"]
    got = tconfig.parse_train_config(argv)
    want = jconfig.parse_config(argv)
    for k in ("device_prefetch", "prefetch_depth", "dispatch_depth"):
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("flag", ["--prefetch_depth", "--dispatch_depth"])
@pytest.mark.parametrize("value", [0, -1])
def test_depth_below_one_exits_2(flag, value, capsys):
    """A depth below 1 on the command line is refused (exit 2), as the
    JAX ``_depth`` type refuses it; the default is chosen by leaving the
    flag out."""
    with pytest.raises(SystemExit) as e:
        tmain.main(["--device", "cpu", f"{flag}={value}"])
    assert e.value.code == 2
    assert "must be >= 1" in capsys.readouterr().err


@pytest.mark.parametrize("field", ["dispatch_depth", "prefetch_depth"])
def test_negative_depth_in_a_config_raises(field):
    with pytest.raises(ValueError, match=field):
        tloop.run(tconfig.Config(**{field: -1}, device="cpu",
                                 training_epochs=0))
