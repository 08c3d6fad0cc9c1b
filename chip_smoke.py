#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Run from the root of a checkout. Phases, each fatal on failure:

  1. build both kernels from ``src/`` (one nvcc each, started together,
     sm_90a): paged attention and contiguous decode attention;
  2. check the port's output against a reference on a small input: the
     reduced fp32 model's paged chunk-prefill and decode logits, and its
     contiguous prefill and decode logits, on the card (kernels) against
     the same model on the CPU (plain versions);
  3. serve KAPPA requests (N = 8, 4 problems, max_new 80, page 64,
     prefill chunk 64) through the port's ``serve_eval`` at the published
     width of deepseek-r1-distill-qwen-1.5b with random weights from
     ``--seed``; prompt + max_new exceeds one page, so decoding rows
     grow into a second page, which the scheduler's growth counter must
     show; the kernel launch counters, zeroed just before, must show
     both modes launched and the plain version never called;
  4. hold the kernel against its plain PyTorch version on the card at
     the slice's shapes (H 12, KV 2, hd 128, bf16 pages of 64 tokens):
     decode over the main path's 16 rows and 2-page tables at mixed
     positions with shared and trash-aliased table entries, the main
     path's prefill chunk, and a 64-token chunk; time kernel, plain
     version and
     ``scaled_dot_product_attention`` over pre-gathered K/V (a yardstick
     the port never calls) by CUDA-graph replay, beside the byte / FLOP
     bound and the kernel's eager per-call time;
  5. serve Greedy, BoN, ST-BoN and KAPPA (N = 8, 2 problems, max_new 80)
     through the single-request engine loop (``serve_eval`` with
     ``paged=False``) at the same width; the counters, zeroed just
     before, must show the contiguous decode kernel launched once per
     layer per decode step of the four runs, its plain version and the
     paged kernel never; KAPPA must compact its rows (so the kernel runs
     at fewer rows after the cache gather) and ST-BoN must truncate;
  6. hold the contiguous decode kernel against its plain version on the
     card (bf16, H 12, KV 2, hd 128): the engine path's shapes (8 and 1
     rows, the phase's longest cache, which spans more than one of the
     kernel's S tiles, position at its end), a sliding-window and a ring
     cache at small shapes, and a 4096-slot cache; time it as phase 4
     does, with SDPA over the same cache and mask as the yardstick.

The last lines are the card's name and power limit, one JSON line of
kernel measurements, and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ARCH = "deepseek-r1-distill-qwen-1.5b"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOP_PER_S = 989e12         # H100 SXM, dense tensor cores
TOL = 2e-3                       # kernel vs plain, bf16 inputs, fp32 math


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def hardware_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _median_ms(run, iters: int, repeats: int) -> float:
    """Median over ``repeats`` of ``run()``'s time by CUDA events, per
    call of the ``iters`` calls ``run`` makes."""
    import torch
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def cuda_time_ms(fn, iters: int = 20, repeats: int = 5) -> tuple:
    """(device ms, call ms) per call of ``fn``. Device: ``iters`` calls
    captured in one CUDA graph and replayed, so the host's launch cost is
    out and the card's time for the work remains. Call: ``iters`` eager
    back-to-back calls, which a fast kernel leaves bound by the host's
    per-call cost (wrapper checks, launch)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def eager():
        for _ in range(iters):
            fn()
    return (_median_ms(graph.replay, iters, repeats),
            _median_ms(eager, iters, repeats))


def paged_case(B, C, pos0, MP, P, seed, dtype, idle_rows=0):
    """Slice-shaped operands: q (B, C, 12, 128), pages (P, 64, 2, 128),
    scrambled tables with trash-aliased tails (page P - 1), the first
    page shared by rows 0 and 1, and ``idle_rows`` trailing rows that
    hold no pages at all (table all trash, position 0), as the
    scheduler's free rows do."""
    import torch
    H, KV, hd, ps = 12, 2, 128, 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, C, H, hd), generator=g, device="cuda").to(dtype)
    kp = torch.randn((P, ps, KV, hd), generator=g, device="cuda").to(dtype)
    vp = torch.randn((P, ps, KV, hd), generator=g, device="cuda").to(dtype)
    bt = torch.full((B, MP), P - 1, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(seed))
    used = 0
    for b in range(B - idle_rows):
        owned = (pos0[b] + C - 1) // ps + 1
        bt[b, :owned] = perm[used:used + owned]
        used += owned
    if B - idle_rows > 1:
        bt[1, 0] = bt[0, 0]
    pos = torch.tensor(pos0, dtype=torch.int32)
    return q, kp, vp, bt.cuda(), pos.cuda()


def bound_ms(q, kp, bt, pos) -> tuple:
    """Least time for the work these inputs need: K/V bytes of the
    positions each (row, KV head) attends to (each read once), q read and
    the fp32 output written once, over the HBM rate; or the QK^T and PV
    FLOPs of the unmasked (query, key) pairs over the bf16 peak."""
    B, C, H, hd = q.shape
    KV = kp.shape[2]
    es = q.element_size()
    pos0 = pos.cpu().tolist()
    kv_tokens = sum(p + C for p in pos0)                  # per KV head
    nbytes = (2 * kv_tokens * KV * hd * es + q.numel() * es
              + q.numel() * 4 + bt.numel() * 4 + pos.numel() * 4)
    pairs = sum(sum(p + c + 1 for c in range(C)) for p in pos0) * H
    flops = 4 * pairs * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_bound_ms(q, k, pos: int, window: int, ring: bool) -> tuple:
    """Least time for one contiguous decode: the K/V bytes of the valid
    slots (each read once), q read and the fp32 output written once, over
    the HBM rate; or the QK^T and PV FLOPs of the valid slots over the
    bf16 peak."""
    from repro_torch.kernels.decode_attn.ref import slot_valid
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    n_valid = int(slot_valid(S, pos, window, ring, "cpu").sum())
    es = q.element_size()
    nbytes = 2 * B * n_valid * KV * hd * es + q.numel() * (es + 4)
    flops = 4 * B * H * n_valid * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(q, kp, vp, bt, pos):
    """scaled_dot_product_attention over K/V gathered beforehand (the
    gather is not timed): the PyTorch yardstick for the same function."""
    import torch
    import torch.nn.functional as F
    B, C, H, hd = q.shape
    _, ps, KV, _ = kp.shape
    MP = bt.shape[1]
    G = H // KV
    k = kp[bt.long()].reshape(B, MP * ps, KV, hd).repeat_interleave(G, 2)
    v = vp[bt.long()].reshape(B, MP * ps, KV, hd).repeat_interleave(G, 2)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kv_pos = torch.arange(MP * ps, device="cuda")
    qpos = pos.long()[:, None] + torch.arange(C, device="cuda")[None]
    mask = (kv_pos[None, None, :] <= qpos[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def kernel_phase(results: list) -> None:
    """Kernel vs plain version at the main path's shapes (the JSON
    entries) and at the 64-token chunk a long prompt gives (checked and
    timed, printed). The main path's prompts are 9-15 tokens and its
    requests need at most 95 positions: its pool holds 32 pages + trash
    and its tables 2 pages. Decode runs 16 rows (2 idle, as free rows
    are) at positions 12..94, six of them past the first page; prefill
    one 15-token chunk at position 0 through its 1-page table prefix."""
    import torch
    from repro_torch.kernels.paged_attn import ops
    from repro_torch.kernels.paged_attn.ref import paged_attn_ref
    cases = [
        ("decode", True, dict(B=16, C=1, MP=2, P=33, idle_rows=2,
                              pos0=[12, 20, 28, 37, 44, 52, 58, 63, 64, 70,
                                    77, 83, 88, 94, 0, 0])),
        ("prefill", True, dict(B=1, C=15, MP=1, P=33, pos0=[0])),
        ("prefill", False, dict(B=1, C=64, MP=2, P=8, pos0=[64])),
    ]
    for i, (kind, main_shape, c) in enumerate(cases):
        q, kp, vp, bt, pos = paged_case(c["B"], c["C"], c["pos0"], c["MP"],
                                        c["P"], seed=i + 1,
                                        dtype=torch.bfloat16,
                                        idle_rows=c.get("idle_rows", 0))
        call = ops.paged_decode_attn if kind == "decode" \
            else ops.paged_prefill_attn
        qa = q[:, 0].contiguous() if kind == "decode" else q
        out = call(qa, kp, vp, bt, pos)
        torch.cuda.synchronize()
        ref = paged_attn_ref(q, kp, vp, bt, pos)
        ref = ref[:, 0] if kind == "decode" else ref
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=TOL, atol=TOL) \
                or not math.isfinite(err):
            raise AssertionError(f"paged_attn {kind}: kernel disagrees with "
                                 f"the plain version (max abs err {err})")
        ms, call_ms = cuda_time_ms(lambda: call(qa, kp, vp, bt, pos))
        plain_ms, _ = cuda_time_ms(lambda: paged_attn_ref(q, kp, vp, bt, pos))
        lib_ms, _ = cuda_time_ms(library_call(q, kp, vp, bt, pos))
        bms, by = bound_ms(q, kp, bt, pos)
        shape = dict(B=c["B"], C=c["C"], H=12, KV=2, hd=128, ps=64,
                     MP=c["MP"], dtype="bfloat16")
        print(f"kernel paged_attn {kind} {shape}: max_abs_err={err:.3g} "
              f"(tol {TOL}) ms={ms:.4f} (eager call {call_ms:.4f}) "
              f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_ms={bms:.6f} ({by})", flush=True)
        if main_shape:
            results.append(dict(
                name=f"paged_attn_{kind}", route="cuda",
                source="src/repro_torch/kernels/paged_attn/csrc/paged_attn.cu",
                replaces="src/repro/kernels/decode_attn/kernel.py:136",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                call_ms=call_ms, shape=shape))


def decode_library_call(q, k, v, pos: int, window: int, ring: bool):
    """scaled_dot_product_attention over the same cache and mask, K/V
    expanded to every query head beforehand (not timed): the PyTorch
    yardstick for the same function."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn.ref import slot_valid
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    qh = q[:, :, None]                                   # (B, H, 1, hd)
    kh, vh = (t.repeat_interleave(G, 2).transpose(1, 2).contiguous()
              for t in (k, v))                           # (B, H, S, hd)
    mask = slot_valid(S, pos, window, ring, q.device)[None, None, None]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def decode_kernel_phase(results: list, max_seq: int) -> None:
    """The contiguous decode kernel vs its plain version: (a) the engine
    path's shapes, 8 and 1 rows over its longest cache (``max_seq``
    slots, position at the end), which must span more than one S tile so
    the online-softmax rescale across tiles runs; (b) a sliding window
    and a ring cache; (c) a 4096-slot cache. Each is checked and timed;
    (a) with 8 rows is the JSON entry."""
    import torch
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    tile = ops.tile_s()
    if max_seq <= tile:
        raise AssertionError(f"the engine path's cache ({max_seq} slots) "
                             f"fits in one S tile of {tile}")
    cases = [   # (B, H, KV, hd, S, pos, window, ring)
        (8, 12, 2, 128, max_seq, max_seq - 1, 0, False),
        (1, 12, 2, 128, max_seq, max_seq - 1, 0, False),
        (2, 12, 2, 128, 150, 120, 32, False),
        (2, 12, 2, 128, 48, 130, 48, True),
        (8, 12, 2, 128, 4096, 4095, 0, False),
    ]
    for i, (B, H, KV, hd, S, pos, window, ring) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
        kw = dict(window=window, ring=ring)
        out = ops.decode_attn(q, k, v, pos, **kw)
        torch.cuda.synchronize()
        ref = decode_attn_ref(q, k, v, pos, **kw)
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=TOL, atol=TOL) \
                or not math.isfinite(err):
            raise AssertionError(f"decode_attn {(B, S, pos, window, ring)}: "
                                 f"kernel disagrees with the plain version "
                                 f"(max abs err {err})")
        ms, call_ms = cuda_time_ms(lambda: ops.decode_attn(q, k, v, pos, **kw))
        plain_ms, _ = cuda_time_ms(
            lambda: decode_attn_ref(q, k, v, pos, **kw))
        lib_ms, _ = cuda_time_ms(decode_library_call(q, k, v, pos, **kw))
        bms, by = decode_bound_ms(q, k, pos, **kw)
        shape = dict(B=B, S=S, pos=pos, window=window, ring=ring, H=H,
                     KV=KV, hd=hd, tile_s=tile, dtype="bfloat16")
        print(f"kernel decode_attn {shape}: max_abs_err={err:.3g} "
              f"(tol {TOL}) ms={ms:.4f} (eager call {call_ms:.4f}) "
              f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_ms={bms:.6f} ({by})", flush=True)
        if i == 0:
            results.append(dict(
                name="decode_attn", route="cuda",
                source="src/repro_torch/kernels/decode_attn/csrc/"
                       "decode_attn.cu",
                replaces="src/repro/kernels/decode_attn/kernel.py:35",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                call_ms=call_ms, shape=shape))


def engine_phase(cfg, params) -> dict:
    """Greedy, BoN, ST-BoN and KAPPA through the single-request engine
    loop at full width, with the kernel counters zeroed just before the
    four runs and read just after."""
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.paged_attn import ops as paged_ops
    from repro_torch.launch.serve import serve_eval
    decode_ops.reset_counts()
    paged_ops.reset_counts()
    runs = {m: serve_eval(ARCH, m, n=8, problems=2, max_new=80, cfg=cfg,
                          params=params, paged=False, device="cuda")
            for m in ("greedy", "bon", "stbon", "kappa")}
    launches, plain = dict(decode_ops.LAUNCHES), dict(decode_ops.PLAIN)
    paged = dict(paged_ops.LAUNCHES)
    steps = sum(out["steps"] for out in runs.values())
    print(f"engine launches: decode_attn {launches} plain {plain} "
          f"paged_attn {paged} decode_steps={steps} "
          f"(x{cfg.num_layers} layers = {steps * cfg.num_layers})",
          flush=True)
    if launches["decode"] != steps * cfg.num_layers:
        raise AssertionError(f"decode_attn launched {launches['decode']} "
                             f"times for {steps} decode steps")
    if any(plain.values()) or any(paged.values()):
        raise AssertionError(f"engine path ran the plain version {plain} "
                             f"or the paged kernel {paged}")
    for method, out in runs.items():
        for r in out["results"]:
            if not r.tokens or not all(0 <= t < cfg.vocab_size
                                       for t in r.tokens):
                raise AssertionError(f"{method}: bad tokens {r.tokens}")
            if not 0 <= r.chosen_branch < 8 or r.logical_tokens <= 0:
                raise AssertionError(f"{method}: bad result accounting")
        print("engine metric {}: total_toks={:.1f} compute_toks={:.1f} "
              "peak={:.3f}MB device_peak={:.1f}MB steps={} time_s={:.2f} "
              "tok/s={:.1f}".format(
                  method, out["total_tokens"], out["compute_tokens"],
                  out["peak_memory_mb"], out["device_peak_mb"], out["steps"],
                  out["time_s"], out["tokens_per_s"]), flush=True)
    if not any(r.compactions for r in runs["kappa"]["results"]):
        raise AssertionError("KAPPA never compacted its rows")
    if any(r.extra["cutoff"] is None for r in runs["stbon"]["results"]):
        raise AssertionError("ST-BoN never truncated")
    return {"launches": launches["decode"], "steps": steps,
            "max_seq": max(out["max_seq"] for out in runs.values()),
            "metric": {m: {k: out[k] for k in (
                "total_tokens", "compute_tokens", "peak_memory_mb",
                "device_peak_mb", "steps", "time_s", "tokens_per_s")}
                for m, out in runs.items()},
            "compactions": [r.compactions
                            for r in runs["kappa"]["results"]],
            "stbon_cutoffs": [r.extra["cutoff"]
                              for r in runs["stbon"]["results"]]}


def main_path_phase(cfg, params) -> dict:
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.paged_attn import ops
    from repro_torch.launch.serve import serve_eval
    ops.reset_counts()
    decode_ops.reset_counts()
    out = serve_eval(ARCH, "kappa", n=8, problems=4, max_new=80, cfg=cfg,
                     params=params, paged=True, page_size=64,
                     prefill_chunk=64, device="cuda")
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    if any(decode_ops.LAUNCHES.values()) or any(decode_ops.PLAIN.values()):
        raise AssertionError("the paged main path ran contiguous decode "
                             "attention")
    print(f"main path launches: kernel {launches} plain {plain} "
          f"ticks={out['ticks']} decode_page_grows="
          f"{out['decode_page_grows']} page_peak={out['page_peak']} "
          f"decode_steps="
          f"{launches['decode'] // cfg.num_layers} "
          f"prefill_chunks={launches['prefill'] // cfg.num_layers}",
          flush=True)
    if launches["decode"] <= 0 or launches["prefill"] <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if any(plain.values()):
        raise AssertionError(f"main path ran the plain version: {plain}")
    if out["decode_page_grows"] <= 0:
        raise AssertionError("no decoding row grew past its first page")
    for r in out["results"]:
        if not r.tokens or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"bad tokens {r.tokens}")
        if not 0 <= r.chosen_branch < 8 or r.logical_tokens <= 0:
            raise AssertionError("bad result accounting")
    print("main path metric: total_toks={:.1f} device_peak={:.1f}MB "
          "tok/s={:.1f} req/s={:.3f} util={:.3f} time_s={:.2f}".format(
              out["total_tokens"], out["device_peak_mb"],
              out["tokens_per_s"], out["requests_per_s"],
              out["row_utilization"], out["time_s"]), flush=True)
    return {"launches": launches, "metric": {
        k: out[k] for k in ("total_tokens", "compute_tokens",
                            "device_peak_mb", "peak_memory_mb",
                            "tokens_per_s", "requests_per_s",
                            "row_utilization", "ticks", "page_peak",
                            "decode_page_grows", "time_s")}}


def reference_phase(seed: int) -> float:
    """The reduced fp32 model on the card (kernels) against the same model
    on the CPU (plain versions): paged chunk prefill of two rows, then
    decode steps at per-row positions; contiguous prefill of the same
    rows, then decode steps at scalar positions. Returns the max abs
    logit difference."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_cache,
                                    init_paged_cache, prefill, prefill_chunk)
    from repro_torch.weights import init_params
    cfg = get_config(ARCH).reduced(d_model=256, vocab_size=128)
    on_card = init_params(cfg, seed, "cuda")

    def to_cpu(tree):
        if torch.is_tensor(tree):
            return tree.cpu()
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return [to_cpu(v) for v in tree]

    params = {"cuda": on_card, "cpu": to_cpu(on_card)}
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 128, size=(2, 24))
    bt = np.array([[0, 1, 2, 8], [3, 4, 5, 8]], np.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = params[dev]
        pool = init_paged_cache(cfg, 8, 8, dev)
        t = lambda a, dt=None: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dt).to(dev)
        logs = []
        for s in range(0, 24, 8):
            cp = bt[:, (s + np.arange(8)) // 8]
            lg, pool = prefill_chunk(p, cfg, t(prompt[:, s:s + 8],
                                               torch.long),
                                     t([s, s], torch.int32), pool,
                                     t(bt), t(cp))
            logs.append(lg.cpu())
        for step in range(3):
            pos = np.array([24 + step, 24 + step], np.int32)
            lg, pool = decode_step(p, cfg, t([7 + step, 9], torch.long),
                                   t(pos), pool, t(bt))
            logs.append(lg.cpu())
        outs[dev] = torch.stack(logs)
        # the engine loop's path: contiguous prefill of the same two
        # rows, then decode steps at scalar positions through the
        # contiguous decode attention
        cache = init_cache(cfg, 2, 30, dev)
        lg, cache = prefill(p, cfg, t(prompt, torch.long), cache)
        logs = [lg.cpu()]
        for step in range(3):
            lg, cache = decode_step(p, cfg, t([7 + step, 9], torch.long),
                                    24 + step, cache)
            logs.append(lg.cpu())
        outs[dev + "_contiguous"] = torch.stack(logs)
    worst = 0.0
    for path in ("", "_contiguous"):
        card, cpu = outs["cuda" + path], outs["cpu" + path]
        if not torch.isfinite(card).all():
            raise AssertionError("non-finite logits on the card")
        worst = max(worst, float((card - cpu).abs().max()))
        if not torch.allclose(card, cpu, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"card vs CPU logits differ by {worst}")
    print(f"reference: reduced fp32 model, paged and contiguous paths, "
          f"card (kernels) vs CPU (plain) logits max abs diff {worst:.3g} "
          f"(tol 1e-3)", flush=True)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the kernel/metric JSON here")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("run chip_smoke.py from a checkout of the repository "
                    "(src/repro_torch not found beside it)")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hw = hardware_line()
    print(f"card: {hw} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn import build as decode_build
    from repro_torch.kernels.paged_attn import build as paged_build
    from repro_torch.weights import init_params
    t0 = time.monotonic()
    libs = build.build(paged_build.SOURCE, decode_build.SOURCE)
    print(f"built {', '.join(lib.name for lib in libs)} in "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    for lib in libs:
        ptxas = [ln.strip() for ln in
                 lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  {lib.name}: " + " | ".join(ptxas[:8]), flush=True)

    # small-input correctness first (it also warms the CUDA libraries),
    # then the two serving paths, then the kernel timings, whose CUDA
    # graphs and workspaces would otherwise sit in the paths' device peaks
    ref_err = reference_phase(args.seed)
    cfg = get_config(ARCH)                  # published width, bf16
    t0 = time.monotonic()
    params = init_params(cfg, args.seed, "cuda")
    torch.cuda.synchronize()
    print(f"full width: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"H={cfg.num_heads} KV={cfg.num_kv_heads} d_ff={cfg.d_ff} "
          f"V={cfg.vocab_size} {cfg.dtype}, random weights seed "
          f"{args.seed} ({time.monotonic() - t0:.1f}s)", flush=True)
    main = main_path_phase(cfg, params)
    eng = engine_phase(cfg, params)
    del params
    kernels: list = []
    kernel_phase(kernels)
    for k in kernels:
        k["launches"] = main["launches"][k["name"].rsplit("_", 1)[1]]
    decode_kernel_phase(kernels, eng["max_seq"])
    kernels[-1]["launches"] = eng["launches"]

    record = {"kernels": kernels}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({**record, "card": hw, "main_path": main,
                                   "engine": eng,
                                   "reference_max_abs_diff": ref_err},
                                  indent=1))
    print(f"card: {hw}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
