"""Serving launcher of the port: KAPPA or greedy over synthetic task
prompts through the paged scheduler with chunked prefill, printing the
paper's metric columns and the serving throughput.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-r1-distill-qwen-1.5b --method kappa --n 8 \
      --problems 4 --max-new 80 --paged --prefill-chunk 64 --full-width

Without ``--full-width`` the model is the arch's ``reduced()`` smoke
variant (2 layers, d_model 256, fp32, the toy tokenizer's vocabulary).
Weights are random from ``--weight-seed``. Runs on the GPU unless ``--device``
names another one.
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
from repro_torch.serving import rng as rng_lib
from repro_torch.serving.scheduler import PagedScheduler
from repro_torch.weights import init_params

METHODS = ("greedy", "kappa")


def serve_eval(arch: str, method: str, *, n: int = 5, problems: int = 20,
               seed: int = 999, weight_seed: int = 0, max_new: int = 48,
               params=None, cfg=None, sched_rows: int | None = None,
               page_size: int = 64, prefill_chunk: int = 64, device=None,
               verbose: bool = True,
               clock: Optional[Callable[[], float]] = None) -> dict:
    """Serve ``problems`` task prompts with ``method`` through the paged
    scheduler and return the metric dict. ``cfg`` is the model config
    (default: the arch's ``reduced()`` variant at the tokenizer's
    vocabulary); ``params`` overrides the random weights."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} is not ported; have {METHODS}")
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

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = clock()
    max_seq = max(len(p.prompt) for p in test) + max_new
    fan_out = 1 if method == "greedy" else n
    sched = PagedScheduler(params, cfg, kcfg, rows=sched_rows or 2 * fan_out,
                           max_seq=max_seq, page_size=page_size,
                           method=method, eos_id=tok.EOS, bos_id=tok.BOS,
                           prefill_chunk=prefill_chunk, device=device,
                           clock=clock)
    rids = [sched.submit(prob.prompt, rng_lib.prng_key(i))
            for i, prob in enumerate(test)]
    res = sched.run()
    gens = [res[rid] for rid in rids]

    acc = lt = ct = 0
    fbt = 0.0
    peak = 0
    for prob, r in zip(test, gens):
        acc += tasks.check_answer(r.tokens, prob)
        lt += r.logical_tokens
        ct += r.compute_tokens
        fbt += len(r.tokens)
        peak = max(peak, r.peak_cache_bytes)
    tp = sched.throughput()
    out = {
        "arch": cfg.name, "method": method, "n": n,
        "accuracy": acc / len(test),
        "final_branch_tokens": fbt / len(test),
        "total_tokens": lt / len(test),
        "compute_tokens": ct / len(test),
        "peak_memory_mb": peak / 1e6,
        "time_s": clock() - t0,
        "tokens_per_s": tp["tokens_per_s"],
        "requests_per_s": tp["requests_per_s"],
        "row_utilization": tp["row_utilization"],
        "ticks": tp["ticks"],
        "page_utilization": tp["page_utilization"],
        "page_peak": tp["page_peak"],
        "decode_page_grows": tp["decode_page_grows"],
        "device": str(device),
        "device_peak_mb": (torch.cuda.max_memory_allocated(device) / 1e6
                           if device.type == "cuda" else None),
        "results": gens,
    }
    if verbose:
        dev_peak = ("not measured (cpu)" if out["device_peak_mb"] is None
                    else f"{out['device_peak_mb']:.1f}MB")
        print(f"{cfg.name} {method:7s} N={n:3d} acc={out['accuracy']:.3f} "
              f"total_toks={out['total_tokens']:8.1f} "
              f"peak={out['peak_memory_mb']:8.3f}MB device_peak={dev_peak} "
              f"t={out['time_s']:.1f}s | sched: "
              f"{out['tokens_per_s']:.1f} tok/s "
              f"{out['requests_per_s']:.2f} req/s "
              f"util={out['row_utilization']:.2f} on {device}")
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
    ap.add_argument("--rows", type=int, default=None,
                    help="pool rows (default 2x fan-out)")
    ap.add_argument("--paged", action="store_true",
                    help="the paged KV pool scheduler (required: the only "
                         "serving path ported so far)")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published config instead of reduced()")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if not args.paged:
        ap.error("only the paged scheduler is ported: pass --paged")
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = cfg.reduced(vocab_size=tok.VOCAB_SIZE)
    serve_eval(args.arch, args.method, n=args.n, problems=args.problems,
               max_new=args.max_new, seed=args.seed,
               weight_seed=args.weight_seed, cfg=cfg, sched_rows=args.rows,
               page_size=args.page_size, prefill_chunk=args.prefill_chunk,
               device=args.device)


if __name__ == "__main__":
    main()
