"""Serving launcher of the port: Greedy / BoN / ST-BoN / KAPPA over
synthetic task prompts, printing the paper's metric columns.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-r1-distill-qwen-1.5b --method bon --n 8 \
      --problems 2 --max-new 80 --full-width

By default each prompt is served on its own through the single-request
engine loop (``serving/engine.py:_decode_loop``), as the JAX launcher
does without ``--scheduler``. ``--paged`` serves the prompts together
through the paged scheduler with chunked prefill instead (greedy and
KAPPA only) and adds the throughput columns.

Without ``--full-width`` the model is the arch's ``reduced()`` smoke
variant (2 layers, d_model 256, fp32, the toy tokenizer's vocabulary).
Weights are random from ``--weight-seed``. Runs on the GPU unless
``--device`` names another one.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import KappaConfig
from repro_torch.data import tasks
from repro_torch.data import tokenizer as tok
from repro_torch.device import resolve_device
from repro_torch.serving import engine, strategies
from repro_torch.serving import rng as rng_lib
from repro_torch.serving.scheduler import SCHEDULED_METHODS, PagedScheduler
from repro_torch.weights import init_params

METHODS = ("bon", "greedy", "kappa", "stbon")


def _strategy_factory(method: str, kcfg: KappaConfig):
    if method == "stbon":
        # ST-BoN's fixed buffer window scales with the gating horizon so
        # truncation happens well before EOS at toy sequence lengths
        return lambda: strategies.STBoNStrategy(
            buffer_window=max(2, kcfg.horizon))
    return lambda: strategies.make_strategy(method)


def serve_eval(arch: str, method: str, *, n: int = 5, problems: int = 20,
               seed: int = 999, weight_seed: int = 0, max_new: int = 48,
               params=None, cfg=None, paged: bool = False,
               sched_rows: int | None = None, page_size: int = 64,
               prefill_chunk: int = 64, device=None, verbose: bool = True,
               clock: Optional[Callable[[], float]] = None) -> dict:
    """Serve ``problems`` task prompts with ``method`` and return the
    metric dict: through the paged scheduler (``paged=True``; greedy and
    KAPPA), or one prompt at a time through the single-request engine
    loop (``paged=False``; every method), as the JAX ``serve_eval`` does
    with ``scheduler=False``. ``cfg`` is the model config (default: the
    arch's ``reduced()`` variant at the tokenizer's vocabulary);
    ``params`` overrides the random weights."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; have {METHODS}")
    if paged and method not in SCHEDULED_METHODS:
        raise ValueError(
            f"method {method!r} runs on the engine loop only (paged=False): "
            "BoN and ST-BoN on the paged scheduler are a later slice of "
            "the port (ROADMAP queue 1)")
    device = resolve_device(device)
    clock = clock or time.monotonic
    if cfg is None:
        cfg = get_config(arch).reduced(vocab_size=tok.VOCAB_SIZE)
    if params is None:
        params = init_params(cfg, weight_seed, device)

    kcfg = KappaConfig(num_branches=n, max_new_tokens=max_new, max_cutoff=6,
                       horizon=8, window=8, mom_buckets=4)
    test = tasks.make_dataset(seed, problems, min_steps=2, max_steps=5,
                              num_ops=2, max_operand=10)
    factory = _strategy_factory(method, kcfg)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    max_seq = max(len(p.prompt) for p in test) + max_new
    t0 = clock()
    if paged:
        sched = PagedScheduler(params, cfg, kcfg,
                               rows=sched_rows or 2 * factory().rows(kcfg),
                               max_seq=max_seq, page_size=page_size,
                               method=method, eos_id=tok.EOS, bos_id=tok.BOS,
                               prefill_chunk=prefill_chunk, device=device,
                               clock=clock)
        rids = [sched.submit(prob.prompt, rng_lib.prng_key(i))
                for i, prob in enumerate(test)]
        res = sched.run()
        gens = [res[rid] for rid in rids]
    else:
        gens = [engine._decode_loop(params, cfg, kcfg, prob.prompt,
                                    rng_lib.prng_key(i), factory(),
                                    eos_id=tok.EOS, bos_id=tok.BOS,
                                    device=device)
                for i, prob in enumerate(test)]
    elapsed = clock() - t0

    acc = lt = ct = 0
    fbt = 0.0
    peak = 0
    for prob, r in zip(test, gens):
        acc += tasks.check_answer(r.tokens, prob)
        lt += r.logical_tokens
        ct += r.compute_tokens
        fbt += len(r.tokens)
        peak = max(peak, r.peak_cache_bytes)
    out = {
        "arch": cfg.name, "method": method, "n": n,
        "accuracy": acc / len(test),
        "final_branch_tokens": fbt / len(test),
        "total_tokens": lt / len(test),
        "compute_tokens": ct / len(test),
        "peak_memory_mb": peak / 1e6,
        "time_s": elapsed,
        "tokens_per_s": lt / max(elapsed, 1e-9),
        "max_seq": max_seq,
        "device": str(device),
        "device_peak_mb": (torch.cuda.max_memory_allocated(device) / 1e6
                           if device.type == "cuda" else None),
        "results": gens,
    }
    if paged:
        tp = sched.throughput()
        out.update({k: tp[k] for k in (
            "tokens_per_s", "requests_per_s", "row_utilization", "ticks",
            "page_utilization", "page_peak", "decode_page_grows")})
    else:
        out["steps"] = sum(r.steps for r in gens)
    if verbose:
        dev_peak = ("not measured (cpu)" if out["device_peak_mb"] is None
                    else f"{out['device_peak_mb']:.1f}MB")
        line = (f"{cfg.name} {method:7s} N={n:3d} acc={out['accuracy']:.3f} "
                f"total_toks={out['total_tokens']:8.1f} "
                f"peak={out['peak_memory_mb']:8.3f}MB device_peak={dev_peak} "
                f"t={out['time_s']:.1f}s | ")
        if paged:
            line += (f"sched: {out['tokens_per_s']:.1f} tok/s "
                     f"{out['requests_per_s']:.2f} req/s "
                     f"util={out['row_utilization']:.2f}")
        else:
            line += (f"engine: {out['tokens_per_s']:.1f} tok/s "
                     f"steps={out['steps']}")
        print(f"{line} on {device}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-r1-distill-qwen-1.5b")
    ap.add_argument("--method", default="kappa", choices=METHODS)
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--problems", type=int, default=20)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--seed", type=int, default=999,
                    help="seed of the task prompts")
    ap.add_argument("--weight-seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV pool scheduler (greedy "
                         "and kappa) instead of the single-request engine "
                         "loop")
    ap.add_argument("--rows", type=int, default=None,
                    help="paged: pool rows (default 2x fan-out)")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published config instead of reduced()")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.paged and args.method not in SCHEDULED_METHODS:
        ap.error(f"--paged serves {' and '.join(SCHEDULED_METHODS)} only: "
                 f"--method {args.method} on the paged scheduler is a later "
                 "slice of the port (ROADMAP queue 1); drop --paged to serve "
                 "it through the engine loop")
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = cfg.reduced(vocab_size=tok.VOCAB_SIZE)
    serve_eval(args.arch, args.method, n=args.n, problems=args.problems,
               max_new=args.max_new, seed=args.seed,
               weight_seed=args.weight_seed, cfg=cfg, paged=args.paged,
               sched_rows=args.rows, page_size=args.page_size,
               prefill_chunk=args.prefill_chunk, device=args.device)


if __name__ == "__main__":
    main()
