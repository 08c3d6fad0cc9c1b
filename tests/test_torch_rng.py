"""RNG and sampling of the PyTorch port against ``jax.random`` and the
JAX package's sampler (jax 0.9.0, ``jax_threefry_partitionable=True``).

Keys after ``PRNGKey`` / ``split`` and the uniform draws under the
Gumbel noise are bit-exact. The Gumbel values g = -log(t), t = -log(u),
are not: XLA's CPU ``log`` is a polynomial that misses correct rounding
by one ulp on ~14 % of float32 inputs, where PyTorch's rounds correctly,
so each log may differ by an ulp. The test bounds g by those two ulps
propagated (|Δg| ≤ 2·(ulp(g) + ulp(t)/t)). Sampled tokens are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import KappaConfig as JaxKappaConfig
from repro.serving import sampler as jax_sampler
from repro_torch.configs.base import KappaConfig
from repro_torch.serving import rng, sampler
from torch_threads import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 7, 12345, 2 ** 31 - 1]


def _np(key):
    return np.asarray(jax.random.key_data(key)
                      if jnp.issubdtype(key.dtype, jax.dtypes.prng_key)
                      else key).astype(np.int64)


def test_threefry_partitionable_is_the_reference_setting():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), rng.prng_key(seed)
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    for num in (2, 5):
        np.testing.assert_array_equal(_np(jax.random.split(jk, num)),
                                      rng.split(tk, num).numpy())
    # the request stream: key <- split(key)[0], row keys split(split[1], n)
    for _ in range(3):
        jk, jkk = jax.random.split(jk)
        ks = rng.split(tk)
        tk = ks[0]
        np.testing.assert_array_equal(_np(jax.random.split(jkk, 4)),
                                      rng.split(ks[1], 4).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_bit_exact(seed):
    jk = jax.random.PRNGKey(seed)
    tk = rng.prng_key(seed)[None]
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (257,)), np.int64),
        rng.random_bits(tk, 257)[0].numpy())
    tiny = float(jnp.finfo(jnp.float32).tiny)
    ju = jax.random.uniform(jk, (257,), minval=tiny, maxval=1.0)
    np.testing.assert_array_equal(np.asarray(ju),
                                  rng.uniform_tiny(tk, 257)[0].numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_log_rounding(seed):
    jg = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (1, 4096)))[0]
    tk = rng.prng_key(seed)[None]
    tg = rng.gumbel(tk, 4096)[0].numpy()
    t = -np.log(rng.uniform_tiny(tk, 4096)[0].numpy().astype(np.float64))
    bound = 2 * (np.spacing(np.abs(jg)) + np.spacing(t.astype(np.float32)) / t)
    assert np.all(np.abs(jg.astype(np.float64) - tg) <= bound)
    assert np.mean(jg == tg) > 0.5


@pytest.mark.parametrize("V,temperature,top_k,top_p", [
    (128, 0.7, 20, 0.95),        # the paper's sampling (§4.1)
    (1000, 0.7, 20, 0.95),
    (128, 1.0, 0, 1.0),          # plain categorical over the full vocab
    (300, 0.5, 5, 0.5),
])
def test_sample_rows_tokens_equal(V, temperature, top_k, top_p):
    r = np.random.default_rng(V)
    logits = (r.standard_normal((24, V)) * 3).astype(np.float32)
    logits[5, :] = 0.25                       # an all-ties row: index order
    logits[6, 10:30] = logits[6].max() + 1.0  # a tied top-k block
    keys = _np(jax.random.split(jax.random.PRNGKey(V), 24))
    gmask = np.zeros(24, bool)
    gmask[[3, 6]] = True
    a = np.asarray(jax_sampler.sample_rows(
        jnp.asarray(keys.astype(np.uint32)), jnp.asarray(logits),
        jnp.asarray(gmask), JaxKappaConfig(temperature=temperature,
                                           top_k=top_k, top_p=top_p)))
    b = sampler.sample_rows(torch.from_numpy(keys), torch.from_numpy(logits),
                            torch.from_numpy(gmask),
                            KappaConfig(temperature=temperature, top_k=top_k,
                                        top_p=top_p)).numpy()
    np.testing.assert_array_equal(a, b)


def test_sample_single_key_batch_equal():
    r = np.random.default_rng(3)
    logits = (r.standard_normal((6, 200)) * 2).astype(np.float32)
    a = np.asarray(jax_sampler.sample(jax.random.PRNGKey(9),
                                      jnp.asarray(logits)))
    b = sampler.sample(rng.prng_key(9), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(a, b)


def test_picked_logprob_matches():
    r = np.random.default_rng(4)
    logits = (r.standard_normal((5, 128)) * 4).astype(np.float32)
    toks = r.integers(0, 128, size=5).astype(np.int32)
    a = np.asarray(jax_sampler.picked_logprob(jnp.asarray(logits),
                                              jnp.asarray(toks)))
    b = sampler.picked_logprob(torch.from_numpy(logits),
                               torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
