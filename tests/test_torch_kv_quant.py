"""The port's int8 paged KV pools against the JAX package's, on the CPU,
at the ``tests/test_serving.py`` sizes (2 blocks, d_model 32, vocab 50).

- ``int8_scale`` / ``quantize_int8`` / ``dequantize_int8`` /
  ``int8_roundtrip`` are bitwise to JAX's over edge values: all-zero
  rows, the +-127 boundaries, values that round at .5, magnitudes from
  2^-30 to 2^30.
- The int8 cache layout equals JAX's; chained int8 ``paged_decode_step``
  and int8 ``prefill_into_pages`` give JAX's logits (f32: within 1e-5
  absolute; the pools' int8 values within 1 and their scales within
  1e-6 relative) on the same params.
- A port int8 ``DecodeEngine`` gives the JAX int8 engine's greedy
  tokens, and the port's own unquantized pool's (the JAX invariant).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.ops import quant as jquant
from distributed_tensorflow_example_tpu.serving import kv_cache as jkvc
from distributed_tensorflow_example_tpu.serving.engine import (
    DecodeEngine as JaxEngine)
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.ops import quant as tquant
from distributed_tensorflow_example_tpu_torch.serving import kv_cache as tkvc
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

_BASE = dict(input_size=32, num_classes=10, seq_len=32, d_model=32,
             n_heads=2, num_blocks=2, d_ff=64, objective="lm",
             vocab_size=50, causal=True)
# f32 logits, port vs JAX on the same params and pools: the products
# sum in other orders (~1e-6 here); a wrong scale or row is off by O(1e-1)
LOGITS_ATOL = 1e-5
# the f32 k/v rows agree to ~1e-7 relative, so a row's int8 value can
# differ by at most one step, where it lands on a .5 boundary
POOL_INT8_ATOL = 1
SCALE_RTOL = 1e-6


@pytest.fixture(scope="module")
def lm():
    jspec = jtfm.TransformerSpec(**_BASE)
    tspec = ttfm.TransformerSpec(**_BASE)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    step = jax.jit(lambda p, c, bt, t, pos: jkvc.paged_decode_step(
        jspec, p, c, bt, t, pos))
    return jspec, jp, tspec, tp, step


def _edge_rows():
    rng = np.random.RandomState(0)
    rows = [np.zeros(16, np.float32),
            np.array([127, -127, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5, 126.5,
                      -126.5, 0, 1, -1, 3.5, 64.5, 100.49999], np.float32)]
    rows += [(rng.randn(16) * 2.0 ** e).astype(np.float32)
             for e in range(-30, 31, 3)]
    return np.stack(rows)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def test_int8_scale_bitwise_to_jax():
    """``amax / 127`` (1.0 at amax 0) over 25,000 magnitudes from
    1e-30 to 1e31 and the integers 1-4999: the same f32 bits as JAX."""
    rng = np.random.RandomState(1)
    amax = np.concatenate([
        np.zeros(1), np.abs(rng.randn(20000)) * 10.0 ** rng.uniform(
            -30, 30, 20000), np.arange(1, 5000)]).astype(np.float32)
    got = tquant.int8_scale(torch.from_numpy(amax)).numpy()
    want = np.asarray(jquant.int8_scale(jnp.asarray(amax)))
    assert _bits_equal(got, want)


@pytest.mark.parametrize("axis", [None, -1, 0])
def test_int8_quantizers_bitwise_to_jax(axis):
    """quantize (q and scale), dequantize to f32 and bf16 and the round
    trip, per tensor, per row and per column: bitwise to JAX."""
    x = _edge_rows()
    jq, js = jquant.quantize_int8(jnp.asarray(x), axis=axis)
    tq, ts = tquant.quantize_int8(torch.from_numpy(x), axis=axis)
    assert _bits_equal(tq.numpy(), jq) and _bits_equal(ts.numpy(), js)
    assert tq.dtype == torch.int8 and int(tq.abs().max()) <= 127
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.dequantize_int8(jq, js, jdt)
                          .astype(jnp.float32))
        got = tquant.dequantize_int8(tq, ts, tdt).float().numpy()
        assert _bits_equal(got, want)
    assert _bits_equal(
        tquant.int8_roundtrip(torch.from_numpy(x), axis).numpy(),
        jquant.int8_roundtrip(jnp.asarray(x), axis))


def test_init_paged_cache_int8_layout_matches_jax(lm):
    """The int8 pool's names, shapes and dtypes equal JAX's; the
    unquantized pool has no scale planes; an unknown format raises."""
    jspec, _jp, tspec, _tp, _ = lm
    jc = jkvc.init_paged_cache(jspec, 6, 4, quant="int8")
    tc = tkvc.init_paged_cache(tspec, 6, 4, quant="int8", device="cpu")
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
        assert not tc[k].any()
    assert "k0_s" not in tkvc.init_paged_cache(tspec, 6, 4, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        tkvc.init_paged_cache(tspec, 6, 4, quant="int4", device="cpu")


def _assert_pools_close(tcache, jcache):
    for k, jv in jcache.items():
        got = tcache[k].to(torch.float64).numpy()
        want = np.asarray(jv).astype(np.float64)
        if k.endswith("_s"):
            np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0,
                                       err_msg=k)
        else:
            assert np.abs(got - want).max() <= POOL_INT8_ATOL, k


@pytest.mark.parametrize("page_size", [4, 16])
def test_int8_paged_decode_matches_jax(lm, page_size):
    """Nine chained int8 decode steps of 3 sequences, page sizes either
    side of the position count: logits within LOGITS_ATOL of JAX's at
    every step, and the pools and scale planes as JAX's at the end."""
    jspec, jp, tspec, tp, step = lm
    b, steps = 3, 9
    toks = np.random.RandomState(8).randint(0, 50, size=(steps, b))
    per = steps // page_size + 1
    npages = 1 + b * per
    bt = np.asarray([[1 + i * per + j for j in range(per)]
                     for i in range(b)], np.int32)
    jc = jkvc.init_paged_cache(jspec, npages, page_size, quant="int8")
    tc = tkvc.init_paged_cache(tspec, npages, page_size, quant="int8",
                               device="cpu")
    for pos in range(steps):
        posv = np.full((b,), pos, np.int32)
        lj, jc = step(jp, jc, jnp.asarray(bt),
                      jnp.asarray(toks[pos], jnp.int32), jnp.asarray(posv))
        lt, tc = tkvc.paged_decode_step(
            tspec, tp, tc, torch.from_numpy(bt).long(),
            torch.from_numpy(toks[pos]).long(), torch.from_numpy(posv).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGITS_ATOL, err_msg=str(pos))
    _assert_pools_close(tc, jc)


def test_int8_paged_decode_error_vs_unquantized_pool_bounded(lm):
    """The JAX invariant on the port alone: chained int8 decode against
    the compute-dtype pool on the same tokens stays within 0.1 absolute
    of its logits (the bound of tests/test_serving.py) with the same
    greedy argmax at every step."""
    _jspec, _jp, tspec, tp, _ = lm
    b, steps, page_size = 3, 9, 4
    toks = torch.from_numpy(
        np.random.RandomState(8).randint(0, 50, size=(steps, b)))
    per = steps // page_size + 1
    bt = torch.tensor([[1 + i * per + j for j in range(per)]
                       for i in range(b)])
    ref = tkvc.init_paged_cache(tspec, 1 + b * per, page_size, device="cpu")
    q = tkvc.init_paged_cache(tspec, 1 + b * per, page_size, quant="int8",
                              device="cpu")
    for pos in range(steps):
        posv = torch.full((b,), pos)
        lr, ref = tkvc.paged_decode_step(tspec, tp, ref, bt, toks[pos], posv)
        lq, q = tkvc.paged_decode_step(tspec, tp, q, bt, toks[pos], posv)
        assert float((lr - lq).abs().max()) < 0.1, pos
        assert torch.equal(lr.argmax(-1), lq.argmax(-1))


def test_int8_prefill_matches_jax(lm):
    """Two ragged prompts (5 and 11 of a 12-wide bucket) prefilled into
    int8 pages: the last-position logits within LOGITS_ATOL of JAX's,
    the pools and scale planes as JAX's."""
    jspec, jp, tspec, tp, _ = lm
    page_size, p = 4, 12
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 50, size=(2, p)).astype(np.int32)
    lengths = np.asarray([5, 11], np.int32)
    bt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    jc = jkvc.init_paged_cache(jspec, 7, page_size, quant="int8")
    tc = tkvc.init_paged_cache(tspec, 7, page_size, quant="int8",
                               device="cpu")
    lj, jc = jax.jit(lambda *a: jkvc.prefill_into_pages(jspec, *a))(
        jp, jc, jnp.asarray(bt), jnp.asarray(toks), jnp.asarray(lengths))
    lt, tc = tkvc.prefill_into_pages(
        tspec, tp, tc, torch.from_numpy(bt), torch.from_numpy(toks),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGITS_ATOL)
    _assert_pools_close(tc, jc)


@pytest.mark.parametrize("page_size", [4, 16])
def test_int8_engine_matches_jax_int8_engine_and_unquantized(lm, page_size):
    """Six ragged greedy requests through 3 slots: the port's int8
    engine gives the JAX int8 engine's tokens and its own unquantized
    pool's; ``stats()`` names the pool's format."""
    jspec, jp, tspec, tp, _ = lm
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 50, size=n).tolist()
               for n in (3, 7, 5, 11, 2, 8)]
    outs = {}
    for name, eng in (
            ("jax", JaxEngine(jspec, jp, page_size=page_size, max_batch=3,
                              kv_quant="int8")),
            ("int8", DecodeEngine(tspec, tp, page_size=page_size,
                                  max_batch=3, kv_quant="int8",
                                  device="cpu")),
            ("plain", DecodeEngine(tspec, tp, page_size=page_size,
                                   max_batch=3, device="cpu"))):
        rids = [eng.submit(p, 6) for p in prompts]
        eng.run_until_idle()
        outs[name] = [eng.result(r, timeout=10.0)["tokens"] for r in rids]
        if name == "int8":
            assert eng.stats()["kv_quant"] == "int8"
            assert eng.cache["k0"].dtype == torch.int8
    assert outs["int8"] == outs["jax"] == outs["plain"]
