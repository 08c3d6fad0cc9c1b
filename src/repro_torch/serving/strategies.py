"""Decode strategies: each method's per-step controller state and
selection rule behind one uniform interface (DESIGN.md §3).

A ``DecodeStrategy`` owns everything method-specific, while
``RequestState`` holds the method-agnostic host state of one in-flight
request (token log, done mask, RNG stream, token/byte accounting). The
scheduler drives both; every host-side decision (sampling keys, masking,
compaction order, termination) lives here, as in the JAX package, which
is what makes the port's runs comparable with it token for token.

This slice ports the KAPPA and greedy strategies, with KAPPA's
controller pooled across requests (:class:`PooledKappaController`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import KappaConfig, ModelConfig
from repro_torch.core import kappa as kappa_lib
from repro_torch.core.signals import reference_log_q
from repro_torch.models import init_cache, prefill
from repro_torch.serving import cache as cache_lib
from repro_torch.serving import rng as rng_lib
from repro_torch.serving import sampler


@dataclass
class GenResult:
    tokens: List[int]                 # generated tokens of the chosen branch
    chosen_branch: int                # original branch index
    all_tokens: np.ndarray            # (N, T) all branch tokens (-1 pad)
    lengths: np.ndarray               # (N,) live lengths
    logical_tokens: int               # paper-style token count
    compute_tokens: int               # rows actually decoded
    peak_cache_bytes: int             # branch-scaling memory peak
    steps: int
    compactions: List[int] = field(default_factory=list)
    extra: Dict = field(default_factory=dict)


@dataclass
class StepDecision:
    """What a strategy decided after observing one decode step."""
    counted: np.ndarray               # (rows,) bool — log + logical accounting
    keep: Optional[np.ndarray] = None  # sorted row indices to compact to
    stop: bool = False                # request finished


class TokenLog:
    """Host-side per-branch token buffers surviving compaction."""

    def __init__(self, n: int, max_new: int):
        self.buf = np.full((n, max_new), -1, np.int32)
        self.len = np.zeros((n,), np.int64)

    def append(self, branch_ids: np.ndarray, tokens: np.ndarray,
               active: np.ndarray):
        for row, b in enumerate(branch_ids):
            if active[row]:
                self.buf[b, self.len[b]] = tokens[row]
                self.len[b] += 1


def to_host(*tensors):
    """Copy device tensors to host numpy arrays behind ONE wait on the
    device: every copy is queued before the single synchronization."""
    if not tensors[0].is_cuda:
        return tuple(t.numpy() for t in tensors)
    outs = [t.to("cpu", non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return tuple(o.numpy() for o in outs)


def bos_log_q(params, cfg: ModelConfig, bos_id: int, device):
    """Unconditional reference log-probs q from the BOS-only context
    (Alg. 2 line 9), through a one-token contiguous prefill."""
    cache = init_cache(cfg, 1, 1, device)
    tok = torch.full((1, 1), bos_id, dtype=torch.long, device=device)
    logits, _ = prefill(params, cfg, tok, cache)
    return reference_log_q(logits[0])


class PooledKappaController:
    """Device-resident stacked KappaState shared by every kappa request
    in a scheduler pool (DESIGN.md §4).

    The scheduler acquires a slot per admitted kappa request, builds one
    (slots, fan_out) gather map per tick and calls :meth:`dispatch` once,
    whatever the number of active requests. :meth:`publish` stores the
    host copies of (alive, traj, cutoff), fetched by the scheduler in its
    one per-tick transfer, which :class:`KappaStrategy` reads its slice
    of."""

    def __init__(self, params, cfg: ModelConfig, kcfg: KappaConfig, *,
                 slots: int, bos_id: int, device):
        self.kcfg = kcfg
        self.slots = slots
        self.nmax = kcfg.num_branches
        self.device = device
        self.log_q = bos_log_q(params, cfg, bos_id, device)
        self.state = kappa_lib.init_pool(kcfg, slots, device=device)
        self.free = list(range(slots))
        self.row_n = np.full((slots,), self.nmax, np.int32)
        self.pending_reset = np.zeros((slots,), bool)
        self.slot_active = np.zeros((slots,), bool)
        self._init_cut = (kcfg.max_cutoff if kcfg.adaptive_cutoff
                          else kcfg.draft_cutoff)
        # host mirrors of the per-tick controller outputs
        self.alive = np.zeros((slots, self.nmax), bool)
        self.traj = np.zeros((slots, self.nmax), np.float32)
        self.cutoff = np.full((slots,), self._init_cut, np.int32)
        self.dispatches = 0

    def acquire(self, n_rows: int) -> int:
        slot = self.free.pop(0)
        self.pending_reset[slot] = True
        self.slot_active[slot] = True
        self.row_n[slot] = n_rows
        self.alive[slot] = np.arange(self.nmax) < n_rows
        self.traj[slot] = 0.0
        self.cutoff[slot] = self._init_cut
        return slot

    def release(self, slot: int) -> None:
        self.slot_active[slot] = False
        self.free.append(slot)
        self.free.sort()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def dispatch(self, pool_logits, pool_toks, gather_idx: np.ndarray,
                 done_prev: np.ndarray, eos_id: int):
        """One controller step of every active slot: re-initialize slots
        acquired since the last tick, gather each slot's branch logits and
        tokens from the row pool (dropped rows point at row 0 and are dead
        in the state), force already-done rows' tokens to EOS, step all
        slots at once; inactive slots keep their state. Returns the
        DEVICE (alive, traj, cutoff) so the caller can fold them into its
        one host transfer of the tick."""
        reset = self._dev(self.pending_reset)
        active = self._dev(self.slot_active)
        fresh = kappa_lib.init_pool_rows(self.kcfg, self._dev(self.row_n))
        state = kappa_lib._map(lambda f, s: kappa_lib._sel(reset, f, s),
                               fresh, self.state)
        gidx = self._dev(gather_idx).long()
        step_logits = pool_logits[gidx]                      # (S, N, V)
        step_toks = torch.where(self._dev(done_prev),
                                torch.full_like(gidx, eos_id),
                                pool_toks[gidx])
        new = kappa_lib.pooled_step(state, step_logits, step_toks,
                                    self.log_q, self.kcfg)
        self.state = kappa_lib._map(
            lambda a, b: kappa_lib._sel(active, a, b), new, state)
        self.pending_reset[:] = False
        self.dispatches += 1
        return self.state.alive, self.state.traj, self.state.cutoff

    def publish(self, out_host) -> None:
        """Store the host copies of this tick's controller outputs."""
        alive, traj, cutoff = out_host
        self.alive = np.array(alive)
        self.traj = np.array(traj)
        self.cutoff = np.array(cutoff)


# ------------------------------------------------------------- strategies

class DecodeStrategy:
    """Per-method controller. Subclasses hold all method-specific state;
    the driving loop only sees rows/begin/step/choose."""

    name = "base"
    greedy = False  # argmax sampling instead of temperature sampling

    def rows(self, kcfg: KappaConfig) -> int:
        return kcfg.num_branches

    def begin(self, kcfg: KappaConfig) -> None:
        self.kcfg = kcfg

    def init_done(self, tokens0: np.ndarray, eos_id: int) -> np.ndarray:
        return np.zeros(tokens0.shape, bool)

    def step(self, in_tokens: np.ndarray, out_tokens: np.ndarray,
             branch_ids: np.ndarray, done: np.ndarray,
             done_prev: np.ndarray, step_idx: int) -> StepDecision:
        raise NotImplementedError

    def choose(self, branch_ids: np.ndarray, done: np.ndarray) -> int:
        return int(branch_ids[0])

    def decided_branch(self, branch_ids: np.ndarray,
                       done: np.ndarray) -> Optional[int]:
        """Branch id whose logged tokens are certain to be the final
        ``choose()`` pick, or None while selection is still open."""
        return None

    def release_pool(self) -> None:
        """Return any shared pooled-controller slot (no-op by default)."""

    def extra(self) -> Dict:
        return {}


class GreedyStrategy(DecodeStrategy):
    """Single deterministic branch decoded to EOS."""

    name = "greedy"
    greedy = True

    def rows(self, kcfg: KappaConfig) -> int:
        return 1

    def init_done(self, tokens0, eos_id):
        return tokens0 == eos_id

    def step(self, in_tokens, out_tokens, branch_ids, done, done_prev,
             step_idx):
        # the EOS token itself is logged/counted (emitted before done)
        return StepDecision(counted=~done_prev,
                            stop=bool(done[branch_ids[0]]))

    def decided_branch(self, branch_ids, done):
        return int(branch_ids[0])   # one branch; every token is final


class KappaStrategy(DecodeStrategy):
    """The paper's KAPPA controller: latent-informativeness scoring with
    scheduled pruning and bucketed compaction (DESIGN.md §2).

    The controller math runs in the scheduler's pooled dispatch
    (:class:`PooledKappaController`); this strategy reads its slot's
    slice of the published host mirrors. ``ctrl_rows`` maps the request's
    current (compaction-survivor) row order onto the slot's controller
    rows; compaction only shrinks the map (dropped rows are dead in the
    state)."""

    name = "kappa"

    def begin(self, kcfg):
        super().begin(kcfg)
        self.chain = cache_lib.bucket_chain(kcfg.num_branches)
        self.pool: Optional[PooledKappaController] = None
        self.slot: Optional[int] = None
        self.ctrl_rows: Optional[np.ndarray] = None
        self._released = False

    def attach_pool(self, pool: PooledKappaController, slot: int,
                    n_rows: int) -> None:
        self.pool, self.slot = pool, slot
        self.ctrl_rows = np.arange(n_rows)

    def release_pool(self) -> None:
        if self.pool is not None:
            self.pool.release(self.slot)
            self.pool = self.slot = self.ctrl_rows = None
            self._released = True

    def _alive_traj(self):
        if self.pool is None:
            raise RuntimeError(
                "KappaStrategy has no pooled-controller slot"
                + (" (read after release_pool — call result() first)"
                   if self._released else ""))
        return (self.pool.alive[self.slot][self.ctrl_rows],
                self.pool.traj[self.slot][self.ctrl_rows])

    def step(self, in_tokens, out_tokens, branch_ids, done, done_prev,
             step_idx):
        kcfg = self.kcfg
        alive, traj = self._alive_traj()
        # ~done_prev: a branch's own EOS-emitting step is logged/counted
        counted = alive & ~done_prev
        keep = None
        rows = len(branch_ids)
        if kcfg.compaction:
            n_alive = int(np.sum(alive))
            bucket = cache_lib.next_bucket(self.chain, max(n_alive, 1), rows)
            if bucket < rows:
                order = np.argsort(~alive * 1_000_000 - traj)  # alive best first
                keep = np.sort(order[:bucket])
                self.ctrl_rows = self.ctrl_rows[keep]
                alive = alive[keep]
        # termination on the post-compaction view
        bids = branch_ids if keep is None else branch_ids[keep]
        live = bids[alive]
        stop = (len(live) == 1 and bool(done[live[0]])) \
            or bool(np.all(done[bids] | ~alive))
        return StepDecision(counted=counted, keep=keep, stop=stop)

    def choose(self, branch_ids, done):
        alive, traj = self._alive_traj()
        masked = np.where(alive, traj, -np.inf)
        return int(branch_ids[int(np.argmax(masked))])

    def decided_branch(self, branch_ids, done):
        # pruning is monotone, so a single survivor IS the final pick
        alive, traj = self._alive_traj()
        if int(np.sum(alive)) != 1:
            return None
        masked = np.where(alive, traj, -np.inf)
        return int(branch_ids[int(np.argmax(masked))])

    def extra(self):
        _, traj = self._alive_traj()
        return {"cutoff": int(self.pool.cutoff[self.slot]),
                "traj": traj.tolist()}


_STRATEGIES = {"greedy": GreedyStrategy, "kappa": KappaStrategy}


def make_strategy(name: str) -> DecodeStrategy:
    if name not in _STRATEGIES:
        raise ValueError(f"method {name!r} is not ported yet; "
                         f"have {sorted(_STRATEGIES)}")
    return _STRATEGIES[name]()


# ----------------------------------------------------------- request state

class RequestState:
    """Method-agnostic host state of one in-flight request: RNG stream,
    done mask, token log, logical/compute/byte accounting. The scheduler
    owns the device cache and applies ``StepDecision.keep`` to its rows.

    ``rng`` is a key (2,) int64 as :func:`repro_torch.serving.rng.prng_key`
    makes it; the stream lives on the host."""

    def __init__(self, strategy: DecodeStrategy, cfg: ModelConfig,
                 kcfg: KappaConfig, prompt_len: int, rng, *, eos_id: int,
                 max_seq: int):
        self.strategy = strategy
        self.cfg = cfg
        self.kcfg = kcfg
        self.eos_id = eos_id
        self.max_seq = max_seq
        self.rng = rng.cpu()
        strategy.begin(kcfg)
        self.n = strategy.rows(kcfg)
        self.log = TokenLog(self.n, kcfg.max_new_tokens + 1)
        self.branch_ids = np.arange(self.n)
        self.pos = prompt_len
        self.step = 0
        self.logical = 0
        self.compute = 0
        self.compactions: List[int] = []
        self.peak = cache_lib.used_cache_bytes(cfg, self.n, self.pos, max_seq)
        self.done: Optional[np.ndarray] = None
        self.cur: Optional[np.ndarray] = None
        self.finished = False

    def first_tokens(self, pf_logits) -> np.ndarray:
        """Sample the fan-out tokens from the prefill logits (V,) — one
        host transfer at admission, as in the JAX package."""
        keys0 = self.step_keys().to(pf_logits.device)
        logits0 = pf_logits[None].expand(self.n, pf_logits.shape[-1])
        gmask = torch.full((self.n,), self.strategy.greedy,
                           device=pf_logits.device)
        cur, = to_host(sampler.sample_rows(keys0, logits0, gmask, self.kcfg))
        self.cur = cur.astype(np.int32)
        self.done = self.strategy.init_done(self.cur, self.eos_id)
        self.log.append(self.branch_ids, self.cur, np.ones(self.n, bool))
        self.logical += self.n
        self.compute += self.n
        if np.all(self.done) or self.kcfg.max_new_tokens <= 1:
            self.finished = True
        return self.cur

    def step_keys(self) -> torch.Tensor:
        """Advance this request's RNG stream and derive one sampling key
        per live row ((rows, 2) int64, on the host)."""
        ks = rng_lib.split(self.rng)
        self.rng = ks[0]
        return rng_lib.split(ks[1], len(self.branch_ids))

    def advance(self, tokens: np.ndarray) -> StepDecision:
        """Host-side work for one decode step given this request's
        pre-sampled next tokens (sampled with its :meth:`step_keys`). The
        caller applies ``decision.keep`` to its cache rows."""
        nxt_np = np.array(tokens, np.int32)
        done_prev = self.done[self.branch_ids].copy()
        nxt_np = np.where(done_prev, self.eos_id, nxt_np)
        self.done[self.branch_ids] |= (nxt_np == self.eos_id)
        self.pos += 1
        self.step += 1
        dec = self.strategy.step(self.cur, nxt_np, self.branch_ids,
                                 self.done, done_prev, self.step)
        self.log.append(self.branch_ids, nxt_np, dec.counted)
        self.logical += int(np.sum(dec.counted))
        self.compute += len(self.branch_ids)
        self.cur = nxt_np
        if dec.keep is not None and len(dec.keep) < len(self.branch_ids):
            # bytes are monotone in pos at fixed row count: sample the
            # peak right before the rows shrink (and again in result())
            self._observe_peak()
        if dec.keep is not None:
            self.branch_ids = self.branch_ids[dec.keep]
            self.cur = self.cur[dec.keep]
            self.compactions.append(len(dec.keep))
        if dec.stop or self.step >= self.kcfg.max_new_tokens - 1:
            self.finished = True
        return dec

    def _observe_peak(self) -> None:
        self.peak = max(self.peak, cache_lib.used_cache_bytes(
            self.cfg, len(self.branch_ids), self.pos, self.max_seq))

    def result(self) -> GenResult:
        self._observe_peak()
        chosen = self.strategy.choose(self.branch_ids, self.done)
        toks = self.log.buf[chosen, :self.log.len[chosen]]
        toks = toks[toks != -1].tolist()
        return GenResult(
            tokens=toks, chosen_branch=chosen, all_tokens=self.log.buf,
            lengths=self.log.len.copy(), logical_tokens=self.logical,
            compute_tokens=self.compute, peak_cache_bytes=self.peak,
            steps=self.step, compactions=self.compactions,
            extra=self.strategy.extra())
