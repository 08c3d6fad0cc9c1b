"""KAPPA controller — per-step state update + prune decision (the paper's
Algorithm 2), as a fixed-shape state machine over N branches.

Phases are encoded in the state rather than in Python control flow:
  draft   : t < cutoff           — no scoring, all branches alive
  gating  : cutoff ≤ t < cutoff+τ — score + prune on the schedule
  continue: one survivor decodes to EOS

Every update is written once, over a leading request-slot axis S: the
pooled controller of a multi-request scheduler steps all its slots in one
call (:func:`pooled_step`), and the single-request :func:`kappa_step` is
the S = 1 case. Each slot's arithmetic touches only its own rows, so a
pooled step is row-for-row the per-request one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import KappaConfig
from repro_torch.core import robust, schedule, scoring, signals

_NEG = -3.4e38


class KappaState(NamedTuple):
    alive: torch.Tensor        # (N,) bool
    prev_kl: torch.Tensor      # (N,) fp32 — D_{t-1} (D_{c-1} ≡ 0)
    di_buf: torch.Tensor       # (N, w) fp32 ring buffer of ΔI
    di_count: torch.Tensor     # () int32 — valid entries in di_buf (≤ w)
    di_ptr: torch.Tensor       # () int32 — monotone ring write pointer
    ema_raw: torch.Tensor      # (N,) fp32 uncorrected EMA
    ema_steps: torch.Tensor    # () int32 — EMA updates so far
    traj_num: torch.Tensor     # (N,) fp32
    traj_den: torch.Tensor     # () fp32
    traj: torch.Tensor         # (N,) fp32 — current trajectory score S_t
    step: torch.Tensor         # () int32 — decode steps taken
    cutoff: torch.Tensor       # () int32 — c (set when draft ends)
    in_gating: torch.Tensor    # () bool
    diverged: torch.Tensor     # (N, N) bool — pairwise prefix divergence
    horizon_dyn: torch.Tensor  # () int32 — effective τ (adaptive horizon)


def _map(fn, *states: KappaState) -> KappaState:
    return KappaState(*(fn(*leaves) for leaves in zip(*states)))


def _sel(mask, a, b):
    """Per-slot select: ``mask`` (S,) broadcast over a's trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def init_state(cfg: KappaConfig, n: Optional[int] = None,
               device="cpu") -> KappaState:
    """Fresh controller state over ``n`` branch rows (default
    ``cfg.num_branches``)."""
    n = cfg.num_branches if n is None else n
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return KappaState(
        alive=torch.ones((n,), dtype=torch.bool, device=device),
        prev_kl=torch.zeros((n,), **f32),
        di_buf=torch.zeros((n, cfg.window), **f32),
        di_count=torch.zeros((), **i32),
        di_ptr=torch.zeros((), **i32),
        ema_raw=torch.zeros((n,), **f32),
        ema_steps=torch.zeros((), **i32),
        traj_num=torch.zeros((n,), **f32),
        traj_den=torch.zeros((), **f32),
        traj=torch.zeros((n,), **f32),
        step=torch.zeros((), **i32),
        cutoff=torch.full((), cfg.max_cutoff if cfg.adaptive_cutoff
                          else cfg.draft_cutoff, **i32),
        in_gating=torch.zeros((), dtype=torch.bool, device=device),
        # diagonal "True" so all-pairwise checks read clean
        diverged=torch.eye(n, dtype=torch.bool, device=device),
        horizon_dyn=torch.full((), cfg.horizon, **i32),
    )


def _score_update(state: KappaState, sigs, cfg: KappaConfig, mask
                  ) -> Tuple[KappaState, torch.Tensor]:
    """One gating-phase scoring step (Alg. 2 lines 13–21) over slots.
    ``mask`` is the z-score population (alive and finite)."""
    kl, conf, ent = sigs
    first = (state.ema_steps == 0)[:, None]
    d_prev = torch.where(first, torch.zeros_like(kl), state.prev_kl)
    di = kl - d_prev
    # ring write at the MONOTONE pointer (di_count clamps at w)
    slot = (state.di_ptr % cfg.window).long()
    idx = slot[:, None, None].expand(di.shape + (1,))
    di_buf = state.di_buf.scatter(2, idx, di[..., None])
    di_ptr = state.di_ptr + 1
    di_count = torch.clamp(state.di_count + 1, max=cfg.window)
    di_hat = robust.median_of_means(di_buf, di_count, cfg.mom_buckets)

    ema_raw = robust.ema_update(state.ema_raw, di_hat, cfg.ema_rate)
    ema_steps = state.ema_steps + 1
    ema_hat = robust.ema_debias(ema_raw, ema_steps, cfg.ema_rate)

    z_ema = scoring.masked_zscore(ema_hat, mask, cfg.zscore_clip)
    z_conf = scoring.masked_zscore(conf, mask, cfg.zscore_clip)
    z_ent = scoring.masked_zscore(ent, mask, cfg.zscore_clip)
    s = scoring.aggregate(z_ema, z_conf, z_ent, cfg.w_kl, cfg.w_conf,
                          cfg.w_ent)
    num, den, traj = scoring.trajectory_update(
        state.traj_num, state.traj_den, s, state.step)
    return state._replace(
        prev_kl=kl, di_buf=di_buf, di_count=di_count, di_ptr=di_ptr,
        ema_raw=ema_raw, ema_steps=ema_steps,
        traj_num=num, traj_den=den, traj=traj), traj


def _total_order_key(x):
    """int32 key ordering float32 values as a total order (-0.0 < +0.0),
    the order jax's sort uses, so ties break as the JAX controller's do."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _prune(alive, traj, r_target):
    """Keep the r_target highest-trajectory alive branches (Alg. 2 l. 25)
    of every slot; dead branches stay dead. alive, traj: (S, N);
    r_target: (S,)."""
    masked = torch.where(alive, traj, torch.full_like(traj, _NEG))
    order = torch.argsort(_total_order_key(-masked), dim=-1, stable=True)
    n = alive.shape[-1]
    ranks = torch.arange(n, dtype=torch.int32, device=alive.device)
    rank = torch.empty_like(order, dtype=torch.int32).scatter_(
        -1, order, ranks.expand_as(order).contiguous())
    return (rank < r_target[:, None]) & alive


def pooled_step(state: KappaState, logits, tokens, log_q,
                cfg: KappaConfig) -> KappaState:
    """One controller update of every slot. state: init_pool-shaped (S,
    ...); logits: (S, N, V) next-token logits of every branch (dead rows
    may hold garbage — they are masked); tokens: (S, N) the tokens just
    sampled; log_q: (V,) unconditional reference log-probs."""
    neq = tokens[:, :, None] != tokens[:, None, :]
    state = state._replace(diverged=state.diverged | neq)
    kl, conf, ent = signals.compute_signals(logits, log_q)

    # finite guard: a branch whose logits went non-finite has its signals
    # zeroed before any reduction, leaves the z-score population, and is
    # killed below — bitwise no-ops when every branch is finite
    finite_ok = torch.all(torch.isfinite(logits), dim=-1)
    zero = torch.zeros_like(kl)
    sigs = (torch.where(finite_ok, kl, zero),
            torch.where(finite_ok, conf, zero),
            torch.where(finite_ok, ent, zero))

    # draft → gating transition (adaptive cutoff à la ST-BoN)
    if cfg.adaptive_cutoff:
        hit = state.diverged.flatten(1).all(dim=1) \
            | (state.step >= cfg.max_cutoff)
    else:
        hit = state.step >= cfg.draft_cutoff
    enter = ~state.in_gating & hit
    cutoff = torch.where(enter, state.step, state.cutoff)
    in_gating = state.in_gating | hit

    # adaptive horizon: at gating entry scale τ by the alive branches'
    # mean normalized entropy
    horizon_dyn = state.horizon_dyn
    if cfg.adaptive_horizon:
        aw = (state.alive & finite_ok).float()
        h_mean = torch.sum(sigs[2] * aw, -1) / torch.clamp(aw.sum(-1), min=1.0)
        h_norm = torch.clamp(
            h_mean / torch.log(torch.tensor(float(logits.shape[-1]),
                                            device=logits.device)), 0.0, 1.0)
        tau = torch.round(cfg.horizon * (1.0 + cfg.horizon_beta
                                         * (2.0 * h_norm - 1.0)))
        tau = torch.clamp(tau, max(2, cfg.horizon // 2),
                          cfg.horizon * 2).to(torch.int32)
        horizon_dyn = torch.where(enter, tau, state.horizon_dyn)
    state = state._replace(cutoff=cutoff, in_gating=in_gating,
                           horizon_dyn=horizon_dyn)

    # gating-phase scoring + pruning (masked when not in gating)
    scored, traj = _score_update(state, sigs, cfg, state.alive & finite_ok)
    gate_rel = torch.minimum(torch.clamp(state.step - cutoff, min=0),
                             horizon_dyn)
    r_target = schedule.survivors(cfg.schedule, cfg.num_branches, gate_rel,
                                  horizon_dyn)
    active_gate = in_gating & (gate_rel < horizon_dyn) \
        & (state.alive.sum(-1) > 1)
    new_alive = _prune(state.alive, traj, r_target)

    out = _map(lambda a, b: _sel(in_gating, a, b), scored, state)
    alive = _sel(active_gate, new_alive, state.alive)
    # finite-guard kill in every phase — unless every alive branch is
    # poisoned, in which case the mask stays as it is
    guarded = alive & finite_ok
    alive = _sel(guarded.any(-1), guarded, alive)
    return out._replace(alive=alive, step=state.step + 1, cutoff=cutoff,
                        in_gating=in_gating, diverged=state.diverged,
                        horizon_dyn=horizon_dyn)


def kappa_step(state: KappaState, logits, tokens, log_q,
               cfg: KappaConfig) -> KappaState:
    """Single-request controller update: logits (N, V), tokens (N,)."""
    pooled = _map(lambda a: a[None], state)
    new = pooled_step(pooled, logits[None], tokens[None], log_q, cfg)
    return _map(lambda a: a[0], new)


# ------------------------------------------------------- pooled controller
#
# A slot always keeps cfg.num_branches rows. Requests admitted with fewer
# rows, and rows dropped by bucketed compaction, are alive=False (their
# diverged pairs forced True at init): dead rows add exact 0.0 terms to
# the masked z-score sums and rank below every alive row in _prune, so a
# slot is exactly the gathered row-subset state (DESIGN.md §4).


def init_pool(cfg: KappaConfig, slots: int, device="cpu") -> KappaState:
    """Stacked controller state for ``slots`` concurrent requests: every
    leaf of init_state gains a leading (slots,) axis."""
    return _map(lambda x: x[None].expand((slots,) + x.shape).clone(),
                init_state(cfg, device=device))


def init_pool_rows(cfg: KappaConfig, row_n) -> KappaState:
    """Per-slot fresh states with per-slot live-row counts row_n (S,)
    (≤ cfg.num_branches); the remaining rows are masked padding."""
    nb = cfg.num_branches
    base = init_pool(cfg, row_n.shape[0], device=row_n.device)
    valid = torch.arange(nb, device=row_n.device)[None, :] < row_n[:, None]
    pad = ~valid
    return base._replace(
        alive=valid,
        diverged=base.diverged | pad[:, :, None] | pad[:, None, :])


def compact_state(state: KappaState, idx) -> KappaState:
    """Gather branch rows for bucketed compaction (single-request state).
    idx: (M,) int of surviving branch indices (M ≤ N)."""
    return state._replace(
        alive=state.alive[idx], prev_kl=state.prev_kl[idx],
        di_buf=state.di_buf[idx], ema_raw=state.ema_raw[idx],
        traj_num=state.traj_num[idx], traj=state.traj[idx],
        diverged=state.diverged[idx][:, idx])
