"""The port's MoE decode against the JAX package's, on the CPU, at a tiny
MoE lm (2 blocks, d_model 32, vocab 50, E 4).

Serving routes a MoE spec by exact dense dispatch (every expert on
every token, the gate-weighted top-k selection combining them) whatever
``moe_dispatch`` says, in both packages.  Held here, top-1 and top-2:

- the contiguous ``decode_step`` over a whole sequence: f32 logits
  within 1e-5 absolute of JAX's at every position;
- paged prefill of two ragged prompts and chained paged decode after
  it: logits within 1e-5 of JAX's, the same greedy choices;
- a spec with ``moe_dispatch="alltoall"`` decodes exactly as the dense
  one (bitwise), in the port as in JAX;
- a port MoE ``DecodeEngine`` gives the JAX MoE engine's greedy tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_example_tpu.models import transformer as jtfm
from distributed_tensorflow_example_tpu.serving import kv_cache as jkvc
from distributed_tensorflow_example_tpu.serving.engine import (
    DecodeEngine as JaxEngine)
from distributed_tensorflow_example_tpu_torch import convert
from distributed_tensorflow_example_tpu_torch.models import transformer as ttfm
from distributed_tensorflow_example_tpu_torch.serving import kv_cache as tkvc
from distributed_tensorflow_example_tpu_torch.serving.engine import (
    DecodeEngine)

# one intra-op thread: the suite runs six test workers (and the rank
# processes) on the machine's cores, where torch would start one a core
torch.set_num_threads(1)

_BASE = dict(input_size=32, num_classes=10, seq_len=32, d_model=32,
             n_heads=2, num_blocks=2, d_ff=64, objective="lm",
             vocab_size=50, causal=True, num_experts=4)
# f32 logits, port vs JAX on the same params: the router's softmax and
# the expert products sum in other orders (~1e-6 here); a wrong gate,
# expert or routing choice moves them by O(1e-1)
LOGITS_ATOL = 1e-5


def _models(topk):
    jspec = jtfm.TransformerSpec(**_BASE, moe_topk=topk)
    tspec = ttfm.TransformerSpec(**_BASE, moe_topk=topk)
    jp = jtfm.init(jax.random.PRNGKey(topk), jspec)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                   tspec, device="cpu")
    return jspec, jp, tspec, tp


@pytest.fixture(scope="module", params=[1, 2], ids=["top1", "top2"])
def moe(request):
    return _models(request.param)


def test_decode_step_matches_jax(moe):
    """16 contiguous decode steps of a batch of 2: logits within
    LOGITS_ATOL of JAX's at every position."""
    jspec, jp, tspec, tp = moe
    toks = np.random.RandomState(4).randint(0, 50, size=(16, 2))
    step = jax.jit(lambda p, c, t, pos: jtfm.decode_step(jspec, p, c, t,
                                                         pos))
    jc = jtfm.init_decode_cache(jspec, 2)
    tc = ttfm.init_decode_cache(tspec, 2, device="cpu")
    for pos in range(16):
        lj, jc = step(jp, jc, jnp.asarray(toks[pos], jnp.int32), pos)
        lt, tc = ttfm.decode_step(tspec, tp, tc,
                                  torch.from_numpy(toks[pos]), pos)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGITS_ATOL, err_msg=str(pos))


def test_paged_prefill_then_decode_matches_jax(moe):
    """Prompts of 5 and 11 tokens prefilled into pages of 4, then 6
    chained greedy paged decode steps: logits within LOGITS_ATOL of
    JAX's throughout, and the same tokens chosen."""
    jspec, jp, tspec, tp = moe
    rng = np.random.RandomState(5)
    toks = rng.randint(0, 50, size=(2, 12)).astype(np.int32)
    lengths = np.asarray([5, 11], np.int32)
    bt = np.asarray([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    jc = jkvc.init_paged_cache(jspec, 11, 4)
    tc = tkvc.init_paged_cache(tspec, 11, 4, device="cpu")
    lj, jc = jax.jit(lambda *a: jkvc.prefill_into_pages(jspec, *a))(
        jp, jc, jnp.asarray(bt[:, :3]), jnp.asarray(toks),
        jnp.asarray(lengths))
    lt, tc = tkvc.prefill_into_pages(
        tspec, tp, tc, torch.from_numpy(bt[:, :3]), torch.from_numpy(toks),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=LOGITS_ATOL)
    step = jax.jit(lambda p, c, b, t, pos: jkvc.paged_decode_step(
        jspec, p, c, b, t, pos))
    nxt = np.asarray(lj).argmax(-1)
    pos = lengths.copy()
    for _ in range(6):
        lj, jc = step(jp, jc, jnp.asarray(bt), jnp.asarray(nxt, jnp.int32),
                      jnp.asarray(pos))
        lt, tc = tkvc.paged_decode_step(
            tspec, tp, tc, torch.from_numpy(bt), torch.from_numpy(nxt),
            torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                                   atol=LOGITS_ATOL)
        assert np.array_equal(lt.argmax(-1).numpy(), np.asarray(lj).argmax(-1))
        nxt = np.asarray(lj).argmax(-1)
        pos = pos + 1


def test_alltoall_spec_decodes_as_dense(moe):
    """``moe_dispatch="alltoall"`` (with a capacity factor that would
    drop tokens in training) decodes bitwise as the dense spec, in the
    port and in JAX; and the paged prefill too."""
    jspec, jp, tspec, tp = moe
    jsa = dataclasses.replace(jspec, moe_dispatch="alltoall",
                              capacity_factor=0.5)
    tsa = dataclasses.replace(tspec, moe_dispatch="alltoall",
                              capacity_factor=0.5)
    tok = np.asarray([3, 17], np.int32)
    outs = []
    for js, ts in ((jspec, tspec), (jsa, tsa)):
        lj, _ = jtfm.decode_step(js, jp, jtfm.init_decode_cache(js, 2),
                                 jnp.asarray(tok), 0)
        lt, _ = ttfm.decode_step(ts, tp, ttfm.init_decode_cache(
            ts, 2, device="cpu"), torch.from_numpy(tok), 0)
        toks = torch.from_numpy(np.arange(8).reshape(1, 8) % 50)
        lp, _ = tkvc.prefill_into_pages(
            ts, tp, tkvc.init_paged_cache(ts, 3, 4, device="cpu"),
            torch.tensor([[1, 2]]), toks, torch.tensor([8]))
        outs.append((np.asarray(lj), lt.numpy(), lp.numpy()))
    for dense, sparse in zip(*outs):
        assert dense.tobytes() == sparse.tobytes()


def test_moe_engine_matches_jax_moe_engine(moe):
    """Five ragged greedy requests through 2 slots at page size 4: the
    port's MoE engine gives the JAX MoE engine's tokens."""
    jspec, jp, tspec, tp = moe
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 50, size=n).tolist() for n in (3, 9, 5, 2, 7)]
    jeng = JaxEngine(jspec, jp, page_size=4, max_batch=2)
    teng = DecodeEngine(tspec, tp, page_size=4, max_batch=2, device="cpu")
    jr = [jeng.submit(p, 6) for p in prompts]
    tr = [teng.submit(p, 6) for p in prompts]
    jeng.run_until_idle()
    teng.run_until_idle()
    assert [teng.result(r)["tokens"] for r in tr] == \
        [jeng.result(r)["tokens"] for r in jr]
