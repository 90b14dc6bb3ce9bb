"""The port's ``utils/prng.py`` against ``jax.random``, on the CPU, bit
for bit: ``PRNGKey``, ``fold_in``, ``split``, 32-bit ``random_bits`` and
``permutation``, in the JAX that the tests run (threefry partitionable
mode, 64-bit types off).  The card's machine has no JAX; there the
card's permutation is held to the CPU's (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu_torch.parallel import epoch
from distributed_tensorflow_example_tpu_torch.utils import prng

SEEDS = [0, 1, 3, 2 ** 31 - 1, 2 ** 40 + 9, -5]
SIZES = [0, 1, 2, 100, 4099, 55000, 65536]


def _key(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


def test_the_jax_under_test_hashes_in_partitionable_mode():
    """The counter layout the port copies is the partitionable one."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _key(jk) == tk
    for data in (0, 1, 5, 0x5EED, 2 ** 32 - 1):
        assert _key(jax.random.fold_in(jk, data)) == prng.fold_in(tk, data)
    for num in (2, 3):
        assert [_key(k) for k in jax.random.split(jk, num)] == list(
            prng.split(tk, num))


def test_fold_in_refuses_what_jax_refuses():
    with pytest.raises(OverflowError):
        jax.random.fold_in(jax.random.PRNGKey(0), -1)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(0), -1)


@pytest.mark.parametrize("n", [1, 2, 7, 1001])
@pytest.mark.parametrize("seed", [0, 7])
def test_random_bits_match_jax(seed, n):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    want = np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64)
    got = prng.random_bits(_key(jk), n, "cpu")
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", SIZES)
def test_shuffle_rounds_follow_the_jax_formula(n):
    want = int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))
    assert prng.shuffle_rounds(n) == want


# (seed, shard, epoch) of the fast path's key chain,
# fold_in(fold_in(PRNGKey(seed + 0x5EED), shard), epoch)
CHAINS = [(1, 0, 0), (1, 0, 3), (3, 1, 19), (2 ** 31 - 1, 0, 7)]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("chain", CHAINS, ids=str)
def test_permutation_matches_jax_on_the_fast_path_key_chain(chain, n):
    seed, shard, ep = chain
    jk = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed + epoch.SHUFFLE_SALT), shard), ep)
    tk = prng.fold_in(prng.fold_in(
        prng.PRNGKey(seed + epoch.SHUFFLE_SALT), shard), ep)
    want = np.asarray(jax.random.permutation(jk, n))
    got = prng.permutation(tk, n, "cpu")
    assert got.dtype == torch.int64 and got.shape == (n,)
    assert np.array_equal(got.numpy(), want)


def test_colliding_keys_at_55000_keep_their_order():
    """At n = 55,000 a round's 32-bit sort keys collide with odds of
    about 0.35 (55000^2 / 2^33): the first epoch of the fast path's
    chain whose rounds hold a tie still matches JAX, because the sort is
    stable."""
    base = prng.fold_in(prng.PRNGKey(1 + epoch.SHUFFLE_SALT), 0)
    for ep in range(64):
        key = prng.fold_in(base, ep)
        k, ties = key, False
        for _ in range(prng.shuffle_rounds(55000)):
            k, sub = prng.split(k)
            bits = prng.random_bits(sub, 55000, "cpu")
            ties |= torch.unique(bits).numel() < 55000
        if ties:
            break
    assert ties, "no epoch in 64 with a tie"
    jk = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(1 + epoch.SHUFFLE_SALT), 0), ep)
    assert np.array_equal(prng.permutation(key, 55000, "cpu").numpy(),
                          np.asarray(jax.random.permutation(jk, 55000)))
