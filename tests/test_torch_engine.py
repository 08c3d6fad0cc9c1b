"""The single-request engine loop of the PyTorch port against the JAX
package's, on the reduced config (2 layers, d_model 256, fp32, the
tokenizer's vocabulary) with the same JAX-initialized weights and the
same numpy-seeded inputs:

  * the contiguous ``decode_step`` at a scalar position (logits and the
    cache it writes), with ``TOL`` of ``test_torch_model.py``: 1e-5 in
    fp32, since matmul and reduction order differ between XLA and
    PyTorch on the CPU;
  * the cache's ``gather_batch`` / ``broadcast_batch``;
  * ``_decode_loop`` for Greedy, BoN, ST-BoN and KAPPA on the same
    prompts and keys: tokens, chosen branch, lengths, logical / compute
    tokens, peak bytes, steps and compactions equal; ``extra``'s
    ``cutoff`` equal, ``traj`` within 1e-5 (the controller's float state
    agrees to 1e-5 per step, ``test_torch_kappa.py`` says why) and
    ``neg_ppl`` within 1e-6 (log-softmax rounds in the last bit);
  * the sequential ``serve_eval``'s metric line against the JAX one
    with ``scheduler=False``.

Every JAX run goes through ``_race_free`` of ``test_torch_scheduler.py``
(the reference's ``jnp.asarray`` copies numpy arguments first).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import KappaConfig as JaxKappaConfig
from repro.data import tokenizer as tok
from repro.launch.serve import serve_eval as jax_serve_eval
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.serving import cache as jax_cache
from repro.serving import engine as jax_engine
from repro.serving import strategies as jax_strategies
from repro_torch.configs import get_config
from repro_torch.configs.base import KappaConfig
from repro_torch.data import tasks
from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.launch.serve import serve_eval
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.serving import cache as cache_lib
from repro_torch.serving import engine, rng, strategies
from repro_torch.weights import from_jax_params
from test_torch_scheduler import _race_free
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "deepseek-r1-distill-qwen-1.5b"
TOL = dict(rtol=1e-5, atol=1e-5)
KCFG = dict(num_branches=4, max_new_tokens=24, max_cutoff=6, horizon=8,
            window=8, mom_buckets=4)
DATA = dict(min_steps=2, max_steps=5, num_ops=2, max_operand=10)
METHODS = ("greedy", "bon", "stbon", "kappa")


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH).reduced(vocab_size=tok.VOCAB_SIZE)
    cfg = get_config(ARCH).reduced(vocab_size=tok.VOCAB_SIZE)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.device_get(jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("B,S,steps", [(1, 5, 3), (3, 9, 4), (4, 1, 2)])
def test_contiguous_decode_step_matches_reference(weights, B, S, steps):
    """Prefill S tokens, then decode ``steps`` tokens at scalar positions
    S, S + 1, ...: the logits and the whole cache agree after each step
    (slots past the position stay zero on both sides)."""
    jcfg, jparams, cfg, params = weights
    r = np.random.default_rng(B * 100 + S)
    prompt = r.integers(0, tok.VOCAB_SIZE, size=(B, S)).astype(np.int32)
    max_seq = S + steps + 2
    _, jc = jax_prefill(jparams, jcfg, jnp.asarray(prompt),
                        jax_init_cache(jcfg, B, max_seq))
    _, tc = prefill(params, cfg, _t(prompt, torch.long),
                    init_cache(cfg, B, max_seq, "cpu"))
    for step in range(steps):
        toks = r.integers(0, tok.VOCAB_SIZE, size=B).astype(np.int32)
        jl, jc = jax_decode_step(jparams, jcfg, jnp.asarray(toks),
                                 jnp.int32(S + step), jc)
        tl, tc = decode_step(params, cfg, _t(toks, torch.long), S + step, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(),
                                       np.asarray(jc["stack"][0][key]), **TOL)


def test_contiguous_decode_runs_the_plain_version_on_cpu(weights):
    """On CPU tensors every layer's decode attention is served by the
    plain version, never the kernel."""
    _, _, cfg, params = weights
    cache = init_cache(cfg, 2, 8, "cpu")
    launches, plain = dict(decode_ops.LAUNCHES), dict(decode_ops.PLAIN)
    decode_step(params, cfg, torch.tensor([1, 2]), 3, cache)
    assert decode_ops.PLAIN["decode"] == plain["decode"] + cfg.num_layers
    assert decode_ops.LAUNCHES == launches


def test_gather_and_broadcast_batch_match_reference(weights):
    jcfg, _, cfg, _ = weights
    r = np.random.default_rng(3)
    jc = jax_init_cache(jcfg, 1, 6)
    shape = jc["stack"][0]["k"].shape                # (L, 1, S, KV, hd)
    k, v = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
    jc = {"stack": ({"k": jnp.asarray(k), "v": jnp.asarray(v)},), "rem": ()}
    tc = {"k": _t(k), "v": _t(v)}
    jb, tb = jax_cache.broadcast_batch(jc, 4), cache_lib.broadcast_batch(tc, 4)
    keep = np.array([0, 2, 3])
    jg, tg = jax_cache.gather_batch(jb, jnp.asarray(keep)), \
        cache_lib.gather_batch(tb, keep)
    for jx, tx in ((jb, tb), (jg, tg)):
        for key in ("k", "v"):
            np.testing.assert_array_equal(tx[key].numpy(),
                                          np.asarray(jx["stack"][0][key]))
    tb["k"][:, 1] = 0.0               # the rows are copies, not views
    np.testing.assert_array_equal(tb["k"][:, 0].numpy(), k[:, 0])
    np.testing.assert_array_equal(tg["k"][:, 1].numpy(), tb["k"][:, 2].numpy())


def _strategy_pair(method):
    if method == "stbon":
        return (jax_strategies.STBoNStrategy(buffer_window=8),
                strategies.STBoNStrategy(buffer_window=8))
    return (jax_strategies.make_strategy(method),
            strategies.make_strategy(method))


@pytest.fixture(scope="module", params=METHODS)
def loop_runs(request, weights):
    """Both engine loops on the same two prompts and keys."""
    jcfg, jparams, cfg, params = weights
    method = request.param
    probs = tasks.make_dataset(999, 2, **DATA)
    jres, tres = [], []
    for i, p in enumerate(probs):
        js, ts = _strategy_pair(method)
        with pytest.MonkeyPatch.context() as mp:
            _race_free(mp)
            jres.append(jax_engine._decode_loop(
                jparams, jcfg, JaxKappaConfig(**KCFG), np.array(p.prompt),
                jax.random.PRNGKey(i), js, eos_id=tok.EOS, bos_id=tok.BOS))
        tres.append(engine._decode_loop(
            params, cfg, KappaConfig(**KCFG), np.array(p.prompt),
            rng.prng_key(i), ts, eos_id=tok.EOS, bos_id=tok.BOS,
            device="cpu"))
    return method, jres, tres


def test_decode_loop_matches_reference(loop_runs):
    method, jres, tres = loop_runs
    for a, b in zip(jres, tres):
        assert a.tokens == b.tokens
        assert a.chosen_branch == b.chosen_branch
        np.testing.assert_array_equal(a.lengths, b.lengths)
        np.testing.assert_array_equal(a.all_tokens, b.all_tokens)
        assert a.logical_tokens == b.logical_tokens
        assert a.compute_tokens == b.compute_tokens
        assert a.peak_cache_bytes == b.peak_cache_bytes
        assert a.steps == b.steps
        assert a.compactions == b.compactions
        assert a.extra.keys() == b.extra.keys()
        if "cutoff" in a.extra:
            assert a.extra["cutoff"] == b.extra["cutoff"]
        if "traj" in a.extra:
            np.testing.assert_allclose(b.extra["traj"], a.extra["traj"],
                                       rtol=1e-5, atol=1e-5)
        if "neg_ppl" in a.extra:
            np.testing.assert_allclose(b.extra["neg_ppl"], a.extra["neg_ppl"],
                                       rtol=1e-6, atol=1e-6)


def test_decode_loop_exercises_each_method(loop_runs):
    """The runs reach each method's distinctive path: KAPPA compacts,
    ST-BoN truncates to one row, BoN decodes the full fan-out."""
    method, _, tres = loop_runs
    if method == "kappa":
        assert any(r.compactions for r in tres)
    elif method == "stbon":
        assert all(r.extra["cutoff"] is not None and r.compactions == [1]
                   for r in tres)
    elif method == "bon":
        assert all(len(r.extra["neg_ppl"]) == KCFG["num_branches"]
                   for r in tres)
    else:
        assert all(len(r.lengths) == 1 for r in tres)


@pytest.mark.parametrize("method", METHODS)
def test_generate_binds_its_strategy(weights, method):
    """``generate_<method>`` is the loop with that method's strategy."""
    _, _, cfg, params = weights
    kcfg = KappaConfig(**dict(KCFG, max_new_tokens=8))
    prompt = np.array(tasks.make_dataset(5, 1, **DATA)[0].prompt)
    gen = getattr(engine, f"generate_{method}")
    kw = dict(eos_id=tok.EOS, bos_id=tok.BOS, device="cpu")
    a = gen(params, cfg, kcfg, prompt, rng.prng_key(3), **kw)
    b = engine._decode_loop(params, cfg, kcfg, prompt, rng.prng_key(3),
                            strategies.make_strategy(method), **kw)
    assert a.tokens == b.tokens and a.logical_tokens == b.logical_tokens


@pytest.mark.parametrize("method", ["kappa", "stbon"])
def test_sequential_serve_eval_matches_reference(weights, method):
    jcfg, jparams, cfg, params = weights
    kw = dict(n=4, problems=2, max_new=16, verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        _race_free(mp)
        ref = jax_serve_eval(ARCH, method, params=jparams, cfg=jcfg,
                             scheduler=False, **kw)
    out = serve_eval(ARCH, method, params=params, cfg=cfg, paged=False,
                     device="cpu", **kw)
    for key in ("accuracy", "total_tokens", "peak_memory_mb",
                "compute_tokens", "final_branch_tokens"):
        assert out[key] == ref[key], key
