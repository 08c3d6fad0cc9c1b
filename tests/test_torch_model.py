"""Model of the PyTorch port against the JAX package at the reduced
config (2 layers, d_model 256, fp32, tokenizer vocabulary): the weight
bridge plus contiguous prefill logits, paged decode logits at per-row
positions, and paged chunk-prefill logits, with the pool contents each
path writes. Both sides take the same JAX-initialized params and the
same numpy-seeded inputs. Tolerance: 1e-5 in fp32 (matmul and reduction
order differ between XLA and PyTorch on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import tokenizer as tok
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_paged_cache as jax_init_paged_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import prefill_chunk as jax_prefill_chunk
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.models import (
    decode_step,
    init_cache,
    init_paged_cache,
    prefill,
    prefill_chunk,
)
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "deepseek-r1-distill-qwen-1.5b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH).reduced(vocab_size=tok.VOCAB_SIZE)
    cfg = get_config(ARCH).reduced(vocab_size=tok.VOCAB_SIZE)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.device_get(jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def test_config_copy_matches_reference():
    """The port's config copy describes the same model, published and
    reduced."""
    import dataclasses
    for reduce in (False, True):
        j, t = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_weight_bridge_layout(models):
    """Layer i of the port is cycle i of the JAX stack; the embedding is
    shared with the unembedding; norms stay fp32 scales around 1 + s."""
    jcfg, jparams, cfg, params = models
    assert len(params["layers"]) == cfg.num_layers
    for i, lp in enumerate(params["layers"]):
        np.testing.assert_array_equal(
            lp["attn"]["wq"].numpy(),
            np.asarray(jparams["stack"][0]["attn"]["wq"][i]))
        np.testing.assert_array_equal(
            lp["ffn"]["wd"].numpy(),
            np.asarray(jparams["stack"][0]["ffn"]["wd"][i]))
        assert set(lp["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
        assert lp["ln1"].dtype == torch.float32
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np.asarray(jparams["embed"]))


@pytest.mark.parametrize("B,S", [(1, 1), (2, 9), (3, 17)])
def test_prefill_logits_and_cache(models, B, S):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(S)
    toks = rng.integers(0, tok.VOCAB_SIZE, size=(B, S)).astype(np.int32)
    jl, jc = jax_prefill(jparams, jcfg, jnp.asarray(toks),
                         jax_init_cache(jcfg, B, S + 3))
    tl, tc = prefill(params, cfg, _t(toks, torch.long),
                     init_cache(cfg, B, S + 3, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(),
                               np.asarray(jc["stack"][0]["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(),
                               np.asarray(jc["stack"][0]["v"]), **TOL)


def _paged_state(jcfg, cfg, rows, num_pages, ps, max_seq, seed):
    """The same random pool contents on both sides (the pool layout of
    an all-global model is the JAX stack's layer axis), scrambled block
    tables with trash-aliased tails, per-row positions and write pages."""
    rng = np.random.default_rng(seed)
    MP = max_seq // ps
    jpool = jax_init_paged_cache(jcfg, rows, num_pages, ps, max_seq)
    shape = jpool["stack"][0]["k"].shape        # (L, P + 1, ps, KV, hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jpool = {"stack": ({"k": jnp.asarray(k), "v": jnp.asarray(v)},),
             "rem": ()}
    pool = init_paged_cache(cfg, num_pages, ps, "cpu")
    pool["k"].copy_(_t(k))
    pool["v"].copy_(_t(v))
    pos = rng.integers(0, max_seq, size=rows).astype(np.int32)
    bt = np.full((rows, MP), num_pages, np.int32)
    perm = rng.permutation(num_pages)
    i = 0
    for r in range(rows):
        owned = int(pos[r]) // ps + 1
        bt[r, :owned] = perm[i:i + owned]
        i += owned
    return jpool, pool, pos, bt


@pytest.mark.parametrize("ps,write_pages", [(4, True), (8, False),
                                            (8, True)])
def test_paged_decode_logits_vector_pos(models, ps, write_pages):
    jcfg, jparams, cfg, params = models
    rows, num_pages, max_seq = 4, 40, 32
    jpool, pool, pos, bt = _paged_state(jcfg, cfg, rows, num_pages, ps,
                                        max_seq, seed=ps)
    toks = np.array([5, 17, 99, 3], np.int32)
    wp = bt[np.arange(rows), pos // ps] if write_pages else None
    for step in range(2):
        jl, jpool = jax_decode_step(
            jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), jpool,
            jnp.asarray(bt), None if wp is None else jnp.asarray(wp))
        tl, pool = decode_step(
            params, cfg, _t(toks, torch.long), _t(pos), pool, _t(bt),
            None if wp is None else _t(wp))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(pool["k"].numpy(),
                                   np.asarray(jpool["stack"][0]["k"]), **TOL)
        toks = (toks * 7 + 1) % tok.VOCAB_SIZE
        pos = np.minimum(pos + 1, max_seq - 1)
        if wp is not None:
            wp = bt[np.arange(rows), pos // ps]


@pytest.mark.parametrize("C,ps", [(4, 8), (3, 4), (8, 8)])
def test_paged_chunk_prefill_logits(models, C, ps):
    """Two rows prefill a prompt chunk by chunk into their own pages; the
    chunk logits and every written page agree with the JAX path."""
    jcfg, jparams, cfg, params = models
    B, num_pages, max_seq = 2, 16, 32
    MP = max_seq // ps
    rng = np.random.default_rng(C * ps)
    prompt = rng.integers(0, tok.VOCAB_SIZE, size=(B, 3 * C)).astype(np.int32)
    bt = np.full((B, MP), num_pages, np.int32)
    perm = rng.permutation(num_pages)
    need = -(-3 * C // ps)
    bt[0, :need] = perm[:need]
    bt[1, :need] = perm[need:2 * need]
    jpool = jax_init_paged_cache(jcfg, B, num_pages, ps, max_seq)
    aux = jax_init_cache(jcfg, B, 1)
    pool = init_paged_cache(cfg, num_pages, ps, "cpu")
    for s in range(0, 3 * C, C):
        piece = prompt[:, s:s + C]
        pos0 = np.full((B,), s, np.int32)
        cpages = bt[:, (s + np.arange(C)) // ps]
        jl, jpool, aux = jax_prefill_chunk(
            jparams, jcfg, jnp.asarray(piece), jnp.asarray(pos0), 0, jpool,
            jnp.asarray(bt), jnp.asarray(cpages), aux)
        tl, pool = prefill_chunk(params, cfg, _t(piece, torch.long),
                                 _t(pos0), pool, _t(bt), _t(cpages))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(pool["v"].numpy(),
                               np.asarray(jpool["stack"][0]["v"]), **TOL)


def test_paged_paths_run_the_plain_version_on_cpu(models):
    """On CPU tensors the paged attention of both modes is served by the
    plain version, never the kernel."""
    jcfg, jparams, cfg, params = models
    _, pool, pos, bt = _paged_state(jcfg, cfg, 2, 8, 8, 32, seed=1)
    launches, plain = dict(paged_ops.LAUNCHES), dict(paged_ops.PLAIN)
    decode_step(params, cfg, torch.tensor([1, 2]), _t(pos), pool, _t(bt))
    assert paged_ops.PLAIN["decode"] == plain["decode"] + cfg.num_layers
    assert paged_ops.PLAIN["prefill"] == plain["prefill"]
    assert paged_ops.LAUNCHES == launches
