"""The slice end to end: the PyTorch port's ``PagedScheduler`` against
the JAX package's at the same call shapes — KAPPA with N = 4 over 3
problems, max_new 12, page_size 8, prefill_chunk 4, on the reduced
config with the same JAX-initialized weights. Equal tokens, chosen
branch, logical and compute token counts, compactions and
``peak_cache_bytes``. Plus the port's page allocator against the JAX
one, and the serving entry point's device contract.

The JAX runs here go through ``_race_free``, undone after each run or
tick: it makes ``jnp.asarray`` in the reference's serving modules copy
a numpy argument before handing it to JAX. Without it the JAX
``PagedScheduler`` is not deterministic on the CPU: ``jnp.asarray`` of
an int32 numpy array aliases the host memory instead of copying it,
the dispatch returns before the computation has read it, and the
reference rewrites such arrays in place (``row_n`` in
``PooledKappaController.acquire``, ``row_pos`` / ``row_token`` and the
block tables between ticks), so identical runs in one process can reach
different decisions. With the copies every run gives the port's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import KappaConfig as JaxKappaConfig
from repro.data import tasks as jax_tasks
from repro.data import tokenizer as tok
from repro.models import init_params as jax_init_params
from repro.serving.cache import PageAllocator as JaxPageAllocator
from repro.serving import engine as jax_engine
from repro.serving import scheduler as jax_scheduler
from repro.serving import strategies as jax_strategies
from repro.serving.scheduler import PagedScheduler as JaxPagedScheduler
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.configs.base import KappaConfig
from repro_torch.data import tasks
from repro_torch.device import resolve_device
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_eval
from repro_torch.serving import rng
from repro_torch.serving.cache import PageAllocator
from repro_torch.serving.scheduler import PagedScheduler
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "deepseek-r1-distill-qwen-1.5b"
KCFG = dict(num_branches=4, max_new_tokens=12, max_cutoff=6, horizon=8,
            window=8, mom_buckets=4)
DATA = dict(min_steps=2, max_steps=5, num_ops=2, max_operand=10)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH).reduced(vocab_size=tok.VOCAB_SIZE)
    cfg = get_config(ARCH).reduced(vocab_size=tok.VOCAB_SIZE)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.device_get(jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


class _CopyingJnp:
    """``jax.numpy`` whose ``asarray`` copies a numpy argument first, so
    the array JAX may alias is one nobody rewrites."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        if isinstance(a, np.ndarray):
            a = a.copy()
        return jnp.asarray(a, *args, **kwargs)


def _race_free(mp):
    """Route the reference serving modules' ``jnp`` through
    ``_CopyingJnp`` (see the module docstring)."""
    for mod in (jax_engine, jax_scheduler, jax_strategies):
        mp.setattr(mod, "jnp", _CopyingJnp())


def _serve_both(weights, method, rows):
    jcfg, jparams, cfg, params = weights
    probs = tasks.make_dataset(999, 3, **DATA)
    assert [p.prompt for p in probs] == \
        [p.prompt for p in jax_tasks.make_dataset(999, 3, **DATA)]
    max_seq = max(len(p.prompt) for p in probs) + KCFG["max_new_tokens"]
    kw = dict(rows=rows, max_seq=max_seq, page_size=8, method=method,
              eos_id=tok.EOS, bos_id=tok.BOS, prefill_chunk=4)
    js = JaxPagedScheduler(jparams, jcfg, JaxKappaConfig(**KCFG), **kw)
    jr = [js.submit(np.array(p.prompt), jax.random.PRNGKey(i))
          for i, p in enumerate(probs)]
    with pytest.MonkeyPatch.context() as mp:
        _race_free(mp)
        jres = js.run()
    ts = PagedScheduler(params, cfg, KappaConfig(**KCFG), device="cpu", **kw)
    tr = [ts.submit(np.array(p.prompt), rng.prng_key(i))
          for i, p in enumerate(probs)]
    tres = ts.run()
    return js, [jres[r] for r in jr], ts, [tres[r] for r in tr]


@pytest.fixture(scope="module")
def kappa_runs(weights):
    before = (dict(paged_ops.LAUNCHES), dict(paged_ops.PLAIN))
    runs = _serve_both(weights, "kappa", rows=8)
    return runs, before, (dict(paged_ops.LAUNCHES), dict(paged_ops.PLAIN))


def test_paged_kappa_token_for_token(kappa_runs):
    (_, jres, _, tres), _, _ = kappa_runs
    for a, b in zip(jres, tres):
        assert a.tokens == b.tokens
        assert a.chosen_branch == b.chosen_branch
        assert a.logical_tokens == b.logical_tokens
        assert a.compute_tokens == b.compute_tokens
        assert a.peak_cache_bytes == b.peak_cache_bytes
        assert a.steps == b.steps
        assert a.compactions == b.compactions
        np.testing.assert_array_equal(a.all_tokens, b.all_tokens)
        assert a.extra["cutoff"] == b.extra["cutoff"]


def test_paged_kappa_scheduler_state_matches(kappa_runs):
    """Same ticks, same row occupancy, same page usage, every page and row
    back on the free lists, and the ≤1-per-tick dispatch contract."""
    (js, _, ts, _), _, _ = kappa_runs
    jt, tt = js.throughput(), ts.throughput()
    for key in ("ticks", "logical_tokens", "compute_tokens",
                "row_utilization", "page_utilization", "page_peak",
                "fused_chunks", "controller_dispatches"):
        assert jt[key] == tt[key], key
    assert ts.alloc.free_count == ts.num_pages
    assert sorted(ts.free) == list(range(ts.rows))
    c = ts.counters
    assert c["controller_syncs"] <= c["controller_dispatches"] <= ts.ticks
    assert c["host_syncs"] <= ts.ticks


def test_paged_kappa_grew_decode_pages(kappa_runs):
    """Decoding rows crossed page boundaries and took pages lazily: the
    growth counter moved and the peak of pages in use matches the
    reference's."""
    (js, _, ts, _), _, _ = kappa_runs
    assert ts.counters["decode_page_grows"] > 0
    assert ts.throughput()["decode_page_grows"] == \
        ts.counters["decode_page_grows"]
    assert ts.throughput()["page_peak"] == js.throughput()["page_peak"]


def test_paged_kappa_ran_plain_attention_on_cpu(kappa_runs):
    """Both paged attention modes served the CPU run, by the plain
    version (the kernel counters did not move)."""
    _, (launches0, plain0), (launches1, plain1) = kappa_runs
    assert plain1["decode"] > plain0["decode"]
    assert plain1["prefill"] > plain0["prefill"]
    assert launches1 == launches0


def test_paged_kappa_tick_by_tick(weights):
    """Driven one tick at a time, the two schedulers hold the same block
    tables, refcounts, row positions and tokens, the same PREFILLING and
    active sets, and charge each request the same bytes after every
    tick."""
    jcfg, jparams, cfg, params = weights
    probs = tasks.make_dataset(7, 3, **DATA)
    max_seq = max(len(p.prompt) for p in probs) + KCFG["max_new_tokens"]
    kw = dict(rows=6, max_seq=max_seq, page_size=8, method="kappa",
              eos_id=tok.EOS, bos_id=tok.BOS, prefill_chunk=4)
    js = JaxPagedScheduler(jparams, jcfg, JaxKappaConfig(**KCFG), **kw)
    ts = PagedScheduler(params, cfg, KappaConfig(**KCFG), device="cpu", **kw)
    for i, p in enumerate(probs):
        js.submit(np.array(p.prompt), jax.random.PRNGKey(i))
        ts.submit(np.array(p.prompt), rng.prng_key(i))
    while js.queue or js.active or js.prefilling:
        with pytest.MonkeyPatch.context() as mp:
            _race_free(mp)
            js.tick()
        ts.tick()
        np.testing.assert_array_equal(js.alloc.block, ts.alloc.block)
        np.testing.assert_array_equal(js.alloc.ref, ts.alloc.ref)
        np.testing.assert_array_equal(js.row_pos, ts.row_pos)
        np.testing.assert_array_equal(js.row_token, ts.row_token)
        assert sorted(js.active) == sorted(ts.active)
        assert sorted(js.prefilling) == sorted(ts.prefilling)
        assert js.request_bytes() == ts.request_bytes()
    assert not (ts.queue or ts.active or ts.prefilling)
    assert js.ticks == ts.ticks


def test_paged_greedy_token_for_token(weights):
    _, jres, _, tres = _serve_both(weights, "greedy", rows=2)
    for a, b in zip(jres, tres):
        assert a.tokens == b.tokens
        assert a.logical_tokens == b.logical_tokens
        assert a.peak_cache_bytes == b.peak_cache_bytes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_allocator_matches_reference(seed):
    """The same alloc / share / grow / write-page / free stream gives the
    same block tables, refcounts and free heap on both allocators."""
    r = np.random.default_rng(seed)
    a, b = JaxPageAllocator(24, 4, 8, 5), PageAllocator(24, 4, 8, 5)
    owned = set()
    for _ in range(200):
        op = r.integers(4)
        free_rows = [i for i in range(8) if i not in owned]
        if op == 0 and free_rows and a.can_alloc(2):
            row = int(r.choice(free_rows))
            pages = a.alloc_pages(2)
            assert pages == b.alloc_pages(2)
            a.set_row_pages(row, pages)
            b.set_row_pages(row, pages)
            owned.add(row)
        elif op == 1 and owned and free_rows:
            src = int(r.choice(sorted(owned)))
            dst = int(r.choice(free_rows))
            shared = [int(p) for p in a.row_pages(src)[:1]]
            a.set_row_pages(dst, shared)
            b.set_row_pages(dst, shared)
            owned.add(dst)
        elif op == 2 and owned:
            row = int(r.choice(sorted(owned)))
            if a.owned[row] < 5 and a.can_alloc(1):
                assert a.append_page(row) == b.append_page(row)
                pos = np.array([int(a.owned[row]) * 4 - 1])
                np.testing.assert_array_equal(
                    a.write_page(np.array([row]), pos),
                    b.write_page(np.array([row]), pos))
        elif op == 3 and owned:
            row = int(r.choice(sorted(owned)))
            a.free_row(row)
            b.free_row(row)
            owned.discard(row)
        np.testing.assert_array_equal(a.block, b.block)
        np.testing.assert_array_equal(a.ref, b.ref)
        assert sorted(a.free_pages) == sorted(b.free_pages)


def test_page_allocator_cow_guard():
    b = PageAllocator(8, 4, rows=2, max_pages=3)
    shared = b.alloc_pages(1)
    b.set_row_pages(0, shared)
    b.set_row_pages(1, shared)
    with pytest.raises(AssertionError):      # shared page: COW violation
        b.write_page(np.array([0]), np.array([1]))
    with pytest.raises(AssertionError):      # past the owned table
        b.write_page(np.array([0]), np.array([4]))


def test_serve_eval_on_cpu_reports_the_metric_line():
    out = serve_eval(ARCH, "kappa", n=4, problems=2, max_new=8, paged=True,
                     page_size=8, prefill_chunk=4, device="cpu",
                     verbose=False)
    assert out["device"] == "cpu" and out["device_peak_mb"] is None
    assert out["total_tokens"] > 0 and out["tokens_per_s"] > 0
    assert 0 < out["row_utilization"] <= 1


@pytest.mark.parametrize("method", ["greedy", "kappa"])
def test_serve_cli_runs_engine_loop_without_paged(capsys, method):
    """Without --paged the CLI serves each prompt through the
    single-request engine loop and prints its metric line; with it, the
    paged scheduler's."""
    argv = ["--method", method, "--n", "2", "--problems", "1",
            "--max-new", "4", "--device", "cpu"]
    serve_main(argv)
    out = capsys.readouterr().out
    assert "total_toks=" in out and "engine:" in out and "steps=" in out
    serve_main(argv + ["--paged", "--page-size", "8", "--prefill-chunk", "4"])
    assert "sched:" in capsys.readouterr().out


@pytest.mark.parametrize("method", ["bon", "stbon"])
def test_serve_cli_refuses_paged_bon_and_stbon(capsys, method):
    """BoN and ST-BoN run on the engine loop only: with --paged the CLI
    exits with a usage error naming the ROADMAP item, and the scheduler
    refuses them too."""
    with pytest.raises(SystemExit) as exc:
        serve_main(["--method", method, "--paged", "--device", "cpu"])
    assert exc.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err
    with pytest.raises(ValueError, match="ROADMAP"):
        serve_eval(ARCH, method, problems=1, max_new=4, paged=True,
                   device="cpu", verbose=False)
    with pytest.raises(ValueError, match="ROADMAP"):
        PagedScheduler(None, get_config(ARCH).reduced(), KappaConfig(**KCFG),
                       rows=8, max_seq=32, method=method, eos_id=tok.EOS,
                       device="cpu")


def test_entry_points_default_to_cuda():
    """Without a device argument the port asks for CUDA; with no GPU it
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            serve_eval(ARCH, "greedy", problems=1, max_new=4, verbose=False)
    assert resolve_device("cpu").type == "cpu"
