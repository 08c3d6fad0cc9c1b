"""Where a serving tick's (or engine step's) time goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      [--seed 0] [--engine METHOD] [--out PATH]

Runs the KAPPA main path of ``chip_smoke.py`` (N = 8, 4 problems,
max_new 80, page 64, prefill chunk 64, published width, random weights)
three times through ``serve_eval``: cold (first use of the CUDA
libraries), warm, and warm again under ``torch.profiler``. Reports the
cold and warm metric lines, the host time of each phase the scheduler
marks as a ``sched:*`` range in the profiled run (model step with its
fused chunks, sampling, pooled controller, the tick's one host transfer,
standalone chunks, the whole tick), the device kernels launched per
tick, the device's busy share of that run's wall time (summed kernel
time over wall time), and the kernels with the most device time.
``--engine METHOD`` profiles that method on the single-request engine
loop instead (the engine phase of ``chip_smoke.py``: N = 8, 2 problems,
max_new 80), per decode step, with the loop's ``engine:*`` phases
(model step, sampling with the strategy's step and the one host
transfer, compaction). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch.serve import METHODS, serve_eval
from repro_torch.weights import init_params

ARCH = "deepseek-r1-distill-qwen-1.5b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=METHODS, default=None,
                    help="profile this method on the engine loop")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    params = init_params(cfg, args.seed, "cuda")
    if args.engine:
        method, unit = args.engine, "steps"
        kw = dict(n=8, problems=2, max_new=80, cfg=cfg, params=params,
                  paged=False, device="cuda")
    else:
        method, unit = "kappa", "ticks"
        kw = dict(n=8, problems=4, max_new=80, cfg=cfg, params=params,
                  paged=True, page_size=64, prefill_chunk=64, device="cuda")
    cold = serve_eval(ARCH, method, **kw)
    warm = serve_eval(ARCH, method, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        serve_eval(ARCH, method, verbose=False, **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    # each marked phase appears twice: a host range (CPU) and its
    # annotation on the device timeline, which is not kernel time
    marked = ("sched:", "engine:")
    phases = {e.key: e.cpu_time_total / 1e3 for e in events
              if e.key.startswith(marked) and e.device_type.name == "CPU"}
    kernels = sorted(
        [e for e in events if e.device_type.name == "CUDA"
         and not e.key.startswith(marked)
         and e.self_device_time_total > 0],
        key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = [{"name": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3} for e in kernels[:12]]
    keys = ("total_tokens", "tokens_per_s", "time_s", unit)
    if not args.engine:
        keys += ("requests_per_s", "row_utilization")
    report = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "method": method, "engine_loop": bool(args.engine),
        "cold": {k: cold[k] for k in keys},
        "warm": {k: warm[k] for k in keys + ("device_peak_mb",)},
        "profiled_wall_ms": wall * 1e3,
        "phase_host_ms": phases,
        "device_busy_ms": device_ms,
        "device_kernel_launches": launches,
        f"launches_per_{unit[:-1]}": launches / max(warm[unit], 1),
        "device_busy_share": device_ms / (wall * 1e3),
        "top_kernels": top,
    }
    print(json.dumps(report, indent=1))
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
