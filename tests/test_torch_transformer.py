"""The PyTorch port's transformer serving subset against the JAX
package's, on the CPU, at the ``tests/test_serving.py`` sizes.

Params come from the JAX package's seeded init and are carried across
with ``convert.params_from_numpy``; the port runs on ``device="cpu"``
(kernel wrappers on their plain versions), the JAX side as its own
tests run it (Pallas kernels in interpret mode under ``fused_ln`` /
``fp8_ffn``).  f32 throughout, so the only differences are the order
of f32 sums: logits agree within 1e-5 absolute (values O(1)), greedy
tokens exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.serving import kv_cache as jkvc
from distributed_tensorflow_example_tpu.utils import checkpoint as jckpt
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.serving import kv_cache as tkvc

LOGIT_ATOL = 1e-5
_BASE = dict(input_size=32, num_classes=10, seq_len=32, d_model=32,
             n_heads=2, num_blocks=2, d_ff=64, objective="lm",
             vocab_size=50, causal=True)
_FLAGS = {"plain": {}, "fused_fp8": dict(fused_ln=True, fp8_ffn=True)}


@pytest.fixture(scope="module", params=sorted(_FLAGS))
def pair(request):
    """(jax spec, jax params, port spec, port params) for one flag set."""
    kw = dict(_BASE, **_FLAGS[request.param])
    jspec = jtfm.TransformerSpec(**kw)
    tspec = ttfm.TransformerSpec(**kw)
    jp = jtfm.init(jax.random.PRNGKey(0), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    return jspec, jp, tspec, tp


def test_param_shapes_match_jax():
    for kw in ({}, dict(_BASE)):
        assert ttfm.param_shapes(ttfm.TransformerSpec(**kw)) == \
            jtfm.param_shapes(jtfm.TransformerSpec(**kw))


def test_init_is_seeded_and_shaped():
    """The port's own init: the spec's shapes and param dtype, equal
    for equal seeds, different for different seeds, JAX's scales."""
    spec = ttfm.TransformerSpec(**_BASE)
    a = ttfm.init(spec, seed=3, device="cpu")
    b = ttfm.init(spec, seed=3, device="cpu")
    c = ttfm.init(spec, seed=4, device="cpu")
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        ttfm.param_shapes(spec)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["L0_W1"], c["L0_W1"])
    assert torch.all(a["L1_ln2_g"] == 1) and torch.all(a["L0_b1"] == 0)
    assert abs(float(a["pos"].std()) - 0.02) < 0.005
    assert abs(float(a["L0_W1"].std()) * 32 ** 0.5 - 1.0) < 0.1


def test_moe_param_shapes_and_init_scaling_match_jax():
    """The MoE leaves (router ``Wr``, expert ``We1``/``be1``/``We2``/
    ``be2``) in JAX's shapes and order; the expert weights scaled by
    their ``shape[-2]`` fan-in, as JAX's init scales them (the bits
    differ); a MoE decode step gives JAX's logits on the same params
    (within 1e-5: both route by exact dense dispatch)."""
    spec = ttfm.TransformerSpec(**_BASE, num_experts=3)
    shapes = ttfm.param_shapes(spec)
    assert list(shapes.items()) == list(jtfm.param_shapes(
        jtfm.TransformerSpec(**_BASE, num_experts=3)).items())
    assert shapes["L1_We1"] == (3, 32, 64) and "L0_W1" not in shapes
    p = ttfm.init(spec, seed=2, device="cpu")
    assert abs(float(p["L0_We1"].std()) * 32 ** 0.5 - 1.0) < 0.1
    assert abs(float(p["L0_We2"].std()) * 64 ** 0.5 - 1.0) < 0.1
    assert abs(float(p["L0_Wr"].std()) * 32 ** 0.5 - 1.0) < 0.3
    assert torch.all(p["L1_be1"] == 0) and torch.all(p["L1_be2"] == 0)
    cache = ttfm.init_decode_cache(spec, 1, device="cpu")
    got, _ = ttfm.decode_step(spec, p, cache,
                              torch.zeros(1, dtype=torch.long), 0)
    jspec = jtfm.TransformerSpec(**_BASE, num_experts=3)
    want, _ = jtfm.decode_step(
        jspec, {k: jnp.asarray(v.numpy()) for k, v in p.items()},
        jtfm.init_decode_cache(jspec, 1), jnp.zeros(1, jnp.int32), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_decode_step_matches_jax(pair):
    """The contiguous KV-cached decode (``_decode_forward`` through
    ``_DenseKV``) over several positions: logits within 1e-5."""
    jspec, jp, tspec, tp = pair
    b = 3
    jc = jtfm.init_decode_cache(jspec, b)
    tc = ttfm.init_decode_cache(tspec, b, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: jtfm.decode_step(jspec, p, c, t,
                                                          pos))
    rng = np.random.RandomState(0)
    for pos in range(3):
        tok = rng.randint(0, 50, size=b)
        jl, jc = jstep(jp, jc, jnp.asarray(tok, jnp.int32), jnp.asarray(pos))
        tl, tc = ttfm.decode_step(tspec, tp, tc, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LOGIT_ATOL)
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=0, atol=1e-5)


def test_generate_greedy_matches_jax():
    """Greedy ``generate`` to the full seq_len: token-identical."""
    kw = dict(_BASE)
    jspec, tspec = jtfm.TransformerSpec(**kw), ttfm.TransformerSpec(**kw)
    jp = jtfm.init(jax.random.PRNGKey(1), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    prompt = np.random.RandomState(1).randint(0, 50, size=(2, 5))
    want = np.asarray(jtfm.generate(jspec, jp, jnp.asarray(prompt,
                                                           jnp.int32)))
    got = ttfm.generate(tspec, tp, torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, want)


def _prefill_inputs():
    rng = np.random.RandomState(4)
    lens = np.asarray([3, 6], np.int32)
    toks = np.zeros((2, 8), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, 50, size=n)
    bt = np.asarray([[1, 2], [3, 4]], np.int32)
    return toks, lens, bt


def test_prefill_into_pages_matches_jax(pair):
    """One batched prefill scattered into pages: last-position logits
    within 1e-5 and every page row the prefill wrote within 1e-5."""
    jspec, jp, tspec, tp = pair
    toks, lens, bt = _prefill_inputs()
    jcache = jkvc.init_paged_cache(jspec, 7, 4)
    tcache = tkvc.init_paged_cache(tspec, 7, 4, device="cpu")
    jl, jcache = jkvc.prefill_into_pages(
        jspec, jp, jcache, jnp.asarray(bt), jnp.asarray(toks),
        jnp.asarray(lens))
    tl, tcache = tkvc.prefill_into_pages(
        tspec, tp, tcache, torch.from_numpy(bt), torch.from_numpy(toks),
        torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    for k in tcache:
        np.testing.assert_allclose(tcache[k][1:5].numpy(),
                                   np.asarray(jcache[k])[1:5], rtol=0,
                                   atol=1e-5)


def test_paged_decode_step_matches_jax(pair):
    """Ragged paged decode steps after a prefill (positions differ per
    row, a dead slot writes the scratch page): logits within 1e-5."""
    jspec, jp, tspec, tp = pair
    toks, lens, bt = _prefill_inputs()
    bt3 = np.asarray([[1, 2, 5], [3, 4, 6], [0, 0, 0]], np.int32)
    jcache = jkvc.init_paged_cache(jspec, 7, 4)
    tcache = tkvc.init_paged_cache(tspec, 7, 4, device="cpu")
    _, jcache = jkvc.prefill_into_pages(
        jspec, jp, jcache, jnp.asarray(bt), jnp.asarray(toks),
        jnp.asarray(lens))
    _, tcache = tkvc.prefill_into_pages(
        tspec, tp, tcache, torch.from_numpy(bt), torch.from_numpy(toks),
        torch.from_numpy(lens))
    jstep = jax.jit(lambda p, c, bt_, t, pos: jkvc.paged_decode_step(
        jspec, p, c, bt_, t, pos))
    rng = np.random.RandomState(5)
    pos = np.asarray([3, 6, 0], np.int32)
    for _ in range(3):
        tok = rng.randint(0, 50, size=3).astype(np.int32)
        jl, jcache = jstep(jp, jcache, jnp.asarray(bt3), jnp.asarray(tok),
                           jnp.asarray(pos))
        tl, tcache = tkvc.paged_decode_step(
            tspec, tp, tcache, torch.from_numpy(bt3), torch.from_numpy(tok),
            torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=0, atol=LOGIT_ATOL)
        pos[:2] += 1


def test_params_from_checkpoint_reads_a_jax_checkpoint(tmp_path):
    """A JAX training checkpoint with bf16 params and an optimizer slot
    of the same names and shapes: the port reads the params (not the
    slot) bitwise, as the JAX ``dtx-serve`` reader does."""
    kw = dict(_BASE, param_dtype=jnp.bfloat16)
    jspec = jtfm.TransformerSpec(**kw)
    jp = jtfm.init(jax.random.PRNGKey(2), jspec)
    state = {"opt": {"m": {k: jnp.zeros_like(v) for k, v in jp.items()}},
             "params": jp}
    jckpt.save_checkpoint(str(tmp_path), state, step=7, epoch=1)
    tspec = ttfm.TransformerSpec(**dict(_BASE,
                                        param_dtype=torch.bfloat16))
    params, path = convert.params_from_checkpoint(str(tmp_path), tspec,
                                                  device="cpu")
    assert path.endswith("ckpt-00000007.npz")
    for k, v in jp.items():
        assert params[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            params[k].float().numpy(), np.asarray(v.astype(jnp.float32)))


def test_params_from_numpy_checks_names_and_shapes():
    spec = ttfm.TransformerSpec(**_BASE)
    good = {k: np.zeros(s, np.float32)
            for k, s in ttfm.param_shapes(spec).items()}
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy({k: v for k, v in good.items()
                                   if k != "L0_W1"}, spec, device="cpu")
    bad = dict(good, L0_W1=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="L0_W1"):
        convert.params_from_numpy(bad, spec, device="cpu")
