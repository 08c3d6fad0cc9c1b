"""KAPPA controller of the PyTorch port against the JAX package on
recorded logits and token streams: ``kappa_step`` per request and
``pooled_step`` over request slots (with padded rows), plus the signal,
scoring, robust and schedule pieces.

Every step is checked twice. From the same input state (the reference's,
handed to both), integer and boolean fields must be equal and float
fields agree to 1e-5. XLA's CPU exp/log round differently from
PyTorch's in the last bit, so the signals differ by ~1e-7 relative; the
ΔI = KL_t − KL_{t−1} difference cancels, and the trajectory sum adds
t · s_t with t up to the step count, so one step differs by up to
7e-6 (measured on these streams). Run free over the whole stream, the
integer and boolean fields — alive mask, cutoff, counters, divergence —
stay equal at every step, and the float fields stay within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import KappaConfig as JaxKappaConfig
from repro.core import kappa as jk
from repro.core import robust as jrobust
from repro.core import schedule as jschedule
from repro.core import signals as jsignals
from repro_torch.configs.base import KappaConfig
from repro_torch.core import kappa as tk
from repro_torch.core import robust, schedule, signals
from torch_threads import one_torch_thread  # noqa: F401

FTOL = dict(rtol=1e-5, atol=1e-5)
DRIFT = dict(rtol=1e-4, atol=1e-4)

CONFIGS = {
    "serve": dict(num_branches=4, max_cutoff=6, horizon=8, window=8,
                  mom_buckets=4),
    "fixed_cutoff": dict(num_branches=5, adaptive_cutoff=False,
                         draft_cutoff=3, horizon=6, window=8, mom_buckets=4),
    "cosine_adaptive_horizon": dict(num_branches=6, max_cutoff=5, horizon=8,
                                    window=8, mom_buckets=2,
                                    schedule="cosine",
                                    adaptive_horizon=True),
    "step_schedule": dict(num_branches=8, max_cutoff=4, horizon=8, window=4,
                          mom_buckets=4, schedule="step"),
}


def _cfgs(name):
    return JaxKappaConfig(**CONFIGS[name]), KappaConfig(**CONFIGS[name])


def _stream(n, V, T, seed, poison=False):
    """Recorded per-step (logits, tokens): branches share the first two
    tokens, then diverge; optionally one branch goes non-finite."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((T, n, V)) * 2).astype(np.float32)
    toks = rng.integers(0, V, size=(T, n)).astype(np.int32)
    toks[:2] = toks[:2, :1]
    if poison:
        logits[T // 2:, 1, 3] = np.nan
    return logits, toks


def _assert_state(js, ts, ftol=FTOL):
    for name, a in js._asdict().items():
        a = np.asarray(a)
        b = getattr(ts, name).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, err_msg=name, **ftol)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def _to_torch(js):
    return tk.KappaState(*(torch.from_numpy(np.array(a)) for a in js))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("poison", [False, True])
def test_kappa_step_matches_reference(name, poison):
    jcfg, tcfg = _cfgs(name)
    n, V, T = jcfg.num_branches, 64, 18
    logits, toks = _stream(n, V, T, seed=n + 13 * poison, poison=poison)
    log_q = jsignals.reference_log_q(jnp.asarray(logits[0, 0]))
    t_log_q = torch.from_numpy(np.array(log_q))
    step = jax.jit(jk.kappa_step, static_argnums=(4,))
    js, ts = jk.init_state(jcfg), tk.init_state(tcfg)
    _assert_state(js, ts)
    for t in range(T):
        args = (torch.from_numpy(logits[t]), torch.from_numpy(toks[t]),
                t_log_q, tcfg)
        one = tk.kappa_step(_to_torch(js), *args)
        js = step(js, jnp.asarray(logits[t]), jnp.asarray(toks[t]), log_q,
                  jcfg)
        _assert_state(js, one)
        ts = tk.kappa_step(ts, *args)
        _assert_state(js, ts, DRIFT)


@pytest.mark.parametrize("name", ["serve", "step_schedule"])
def test_pooled_step_matches_reference(name):
    """Slots with fewer live rows than the fan-out (masked padding), and a
    slot reset mid-stream, as the scheduler's pooled tick does."""
    jcfg, tcfg = _cfgs(name)
    n, V, T, S = jcfg.num_branches, 48, 14, 3
    row_n = np.array([n, n - 1, 1], np.int32)
    logits, toks = _stream(S * n, V, T, seed=S * n)
    logits = logits.reshape(T, S, n, V)
    toks = toks.reshape(T, S, n)
    log_q = jsignals.reference_log_q(jnp.asarray(logits[0, 0, 0]))
    t_log_q = torch.from_numpy(np.array(log_q))
    js = jk.init_pool_rows(jcfg, jnp.asarray(row_n))
    ts = tk.init_pool_rows(tcfg, torch.from_numpy(row_n))
    _assert_state(js, ts)
    step = jax.jit(jk.pooled_step, static_argnums=(4,))
    for t in range(T):
        if t == T // 2:        # slot 1 re-acquired by a new request
            js = jax.tree.map(lambda a, f: a.at[1].set(f[1]), js,
                              jk.init_pool_rows(jcfg, jnp.asarray(row_n)))
            ts = tk._map(lambda a, f: torch.cat([a[:1], f[1:2], a[2:]]), ts,
                         tk.init_pool_rows(tcfg, torch.from_numpy(row_n)))
        args = (torch.from_numpy(logits[t]), torch.from_numpy(toks[t]),
                t_log_q, tcfg)
        one = tk.pooled_step(_to_torch(js), *args)
        js = step(js, jnp.asarray(logits[t]), jnp.asarray(toks[t]), log_q,
                  jcfg)
        _assert_state(js, one)
        ts = tk.pooled_step(ts, *args)
        _assert_state(js, ts, DRIFT)


def test_init_pool_and_compact_state():
    jcfg, tcfg = _cfgs("serve")
    _assert_state(jk.init_pool(jcfg, 3), tk.init_pool(tcfg, 3))
    logits, toks = _stream(4, 32, 9, seed=5)
    js = jk.init_state(jcfg)
    log_q = jsignals.reference_log_q(jnp.asarray(logits[0, 0]))
    step = jax.jit(jk.kappa_step, static_argnums=(4,))
    for t in range(9):
        js = step(js, jnp.asarray(logits[t]), jnp.asarray(toks[t]), log_q,
                  jcfg)
    idx = np.array([0, 2], np.int32)
    _assert_state(jk.compact_state(js, jnp.asarray(idx)),
                  tk.compact_state(_to_torch(js), torch.from_numpy(idx).long()))


def test_signals_match():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 200)) * 3).astype(np.float32)
    log_q = jsignals.reference_log_q(jnp.asarray(logits[0, 0]))
    a = jsignals.compute_signals(jnp.asarray(logits), log_q)
    b = signals.compute_signals(torch.from_numpy(logits),
                                torch.from_numpy(np.array(log_q)))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **FTOL)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_median_of_means_and_ema(m):
    rng = np.random.default_rng(m)
    w = 8
    window = rng.standard_normal((5, w)).astype(np.float32)
    for count in range(w + 1):
        a = jrobust.median_of_means(jnp.asarray(window), jnp.int32(count), m)
        b = robust.median_of_means(torch.from_numpy(window)[None],
                                   torch.tensor([count]), m)[0]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **FTOL)
    x = rng.standard_normal(5).astype(np.float32)
    for step in range(4):
        a = jrobust.ema_debias(jnp.asarray(x), jnp.int32(step), 0.5)
        b = robust.ema_debias(torch.from_numpy(x)[None],
                              torch.tensor([step]), 0.5)[0]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **FTOL)


@pytest.mark.parametrize("kind", ["linear", "cosine", "step"])
def test_schedules_equal(kind):
    for horizon in (2, 5, 8, 16):
        steps = np.arange(horizon + 2, dtype=np.int32)
        a = [int(jschedule.survivors(kind, 6, jnp.int32(s), horizon))
             for s in steps]
        b = schedule.survivors(kind, 6, torch.from_numpy(steps),
                               torch.full((len(steps),), horizon,
                                          dtype=torch.int32))
        assert a == b.tolist()


def test_kappa_config_copy_matches_reference():
    assert dataclasses.asdict(JaxKappaConfig()) == \
        dataclasses.asdict(KappaConfig())
