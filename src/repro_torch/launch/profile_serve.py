"""Where a serving tick's time goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve \
      [--seed 0] [--out chiprun_out/profile_serve.json]

Runs the KAPPA main path of ``chip_smoke.py`` (N = 8, 4 problems,
max_new 80, page 64, prefill chunk 64, published width, random weights)
three times through ``serve_eval``: cold (first use of the CUDA
libraries), warm, and warm again under ``torch.profiler``. Reports the
cold and warm metric lines, the host time of each phase the scheduler
marks as a ``sched:*`` range in the profiled run (model step with its
fused chunks, sampling, pooled controller, the tick's one host transfer,
standalone chunks, the whole tick), the device kernels launched per
tick, the device's busy share of that run's wall time (summed kernel
time over wall time), and the kernels with the most device time. Needs
a CUDA device.
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
from repro_torch.launch.serve import serve_eval
from repro_torch.weights import init_params

ARCH = "deepseek-r1-distill-qwen-1.5b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH)
    params = init_params(cfg, args.seed, "cuda")
    kw = dict(n=8, problems=4, max_new=80, cfg=cfg, params=params,
              page_size=64, prefill_chunk=64, device="cuda")
    cold = serve_eval(ARCH, "kappa", **kw)
    warm = serve_eval(ARCH, "kappa", **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        serve_eval(ARCH, "kappa", verbose=False, **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    # each marked phase appears twice: a host range (CPU) and its
    # annotation on the device timeline, which is not kernel time
    phases = {e.key: e.cpu_time_total / 1e3 for e in events
              if e.key.startswith("sched:") and e.device_type.name == "CPU"}
    kernels = sorted(
        [e for e in events if e.device_type.name == "CUDA"
         and not e.key.startswith("sched:")
         and e.self_device_time_total > 0],
        key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    top = [{"name": e.key[:90], "calls": e.count,
            "device_ms": e.self_device_time_total / 1e3} for e in kernels[:12]]
    report = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(),
        "cold": {k: cold[k] for k in ("total_tokens", "tokens_per_s",
                                      "requests_per_s", "time_s", "ticks")},
        "warm": {k: warm[k] for k in ("total_tokens", "tokens_per_s",
                                      "requests_per_s", "row_utilization",
                                      "time_s", "ticks", "device_peak_mb")},
        "profiled_wall_ms": wall * 1e3,
        "phase_host_ms": phases,
        "device_busy_ms": device_ms,
        "device_kernel_launches": launches,
        "launches_per_tick": launches / max(warm["ticks"], 1),
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
