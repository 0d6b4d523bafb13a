"""The port's copy of the jax.random draws (rfhe_tpu_torch/prng.py) against
jax.random itself, bit for bit: keys, splits, randint in both dtypes at every
shape the campaigns use, bernoulli, permutation and choice without
replacement (where sort keys tie)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rfhe_tpu_torch import prng

SEEDS = (0, 5, 42, 2**31 - 1)


@pytest.fixture(scope="module")
def keys():
    """Per-trial keys, as the campaigns split them: (jax, port)."""
    return (np.asarray(jax.random.split(jax.random.PRNGKey(42), 64)),
            prng.split(prng.PRNGKey(42), 64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 8, 12, 1000])
def test_split(num):
    k = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(7), num),
                                  np.asarray(jax.random.split(k, num)))


def test_split_batched(keys):
    """split over a batch of keys is split of each key (jax.vmap)."""
    jk, pk = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, 12))(jnp.asarray(jk)))
    np.testing.assert_array_equal(prng.split(pk, 12), want)


def test_random_bits(keys):
    jk, pk = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (5, 3), jnp.uint32))(jnp.asarray(jk)))
    np.testing.assert_array_equal(prng.random_bits(pk, (5, 3)), want)


SHAPES = [(), (1,), (64,), (7, 8, 8)]
BOUNDS = [(0, 2), (0, 7), (1, 3), (0, 53), (5, 70000), (0, (1 << 24) - 1),
          (0, 1073479681), (0, 2**31 - 1), (9, 9)]


@pytest.mark.parametrize("dtype", [jnp.int32, jnp.uint32], ids=["int32", "uint32"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_randint(keys, dtype, shape):
    """Every span up to 2^31 - 1, batched over 64 keys (the campaigns' vmap)
    and from one key."""
    jk, pk = keys
    for lo, hi in BOUNDS:
        want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi, dtype=dtype))(
            jnp.asarray(jk)))
        got = prng.randint(pk, shape, lo, hi, np.dtype(dtype))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"[{lo}, {hi})")
        np.testing.assert_array_equal(
            prng.randint(pk[3], shape, lo, hi, np.dtype(dtype)),
            np.asarray(jax.random.randint(jnp.asarray(jk[3]), shape, lo, hi, dtype=dtype)))


def test_randint_default_is_int32():
    k = jax.random.PRNGKey(1)
    want = np.asarray(jax.random.randint(k, (10,), 0, 1000))
    got = prng.randint(prng.PRNGKey(1), (10,), 0, 1000)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p, shape", [(0.5, ()), (0.5, (100,)), (0.3, (1000,))])
def test_bernoulli(keys, p, shape):
    jk, pk = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p, shape))(jnp.asarray(jk)))
    np.testing.assert_array_equal(prng.bernoulli(pk, p, shape), want)


def test_uniform():
    k = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(prng.uniform(prng.PRNGKey(3), (4096,)),
                                  np.asarray(jax.random.uniform(k, (4096,))))


@pytest.mark.parametrize("n", [1, 10, 256, 2000, 32768])
def test_permutation(n):
    for seed in (0, 42):
        np.testing.assert_array_equal(prng.permutation(prng.PRNGKey(seed), n),
                                      np.asarray(jax.random.permutation(
                                          jax.random.PRNGKey(seed), n)))


def test_permutation_with_tied_sort_keys():
    """At 2^18 elements each round's 32-bit sort keys tie (8 pairs expected);
    the stable sort keeps tied elements in their order, as lax.sort_key_val
    does."""
    n, seed = 1 << 18, 11
    k = prng.split(prng.PRNGKey(seed))
    sort_keys = prng.random_bits(k[1], n)                 # the first round's
    assert len(np.unique(sort_keys)) < n
    np.testing.assert_array_equal(prng.permutation(prng.PRNGKey(seed), n),
                                  np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)))


@pytest.mark.parametrize("n, k", [(256, 1), (256, 7), (32768, 7), (32768, 1)])
def test_choice_without_replacement(keys, n, k):
    jk, pk = keys
    want = np.asarray(jax.vmap(lambda kk: jax.random.choice(kk, n, shape=(k,), replace=False))(
        jnp.asarray(jk[:4])))
    np.testing.assert_array_equal(prng.choice(pk[:4], n, (k,)), want)
    np.testing.assert_array_equal(
        prng.choice(pk[0], n, (k,)),
        np.asarray(jax.random.choice(jnp.asarray(jk[0]), n, shape=(k,), replace=False)))


def test_out_of_range_refused():
    with pytest.raises(ValueError):
        prng.PRNGKey(2**31)
    with pytest.raises(ValueError):
        prng.randint(prng.PRNGKey(0), (), 0, 2**31, np.uint32)
    with pytest.raises(TypeError):
        prng.randint(prng.PRNGKey(0), (), 0, 10, np.int64)
    with pytest.raises(ValueError):
        prng.choice(prng.PRNGKey(0), 4, (5,))
