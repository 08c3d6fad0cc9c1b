"""Decode strategies: each method's per-step controller state and
selection rule behind one uniform interface (DESIGN.md §3).

A ``DecodeStrategy`` owns everything method-specific — KAPPA's
controller state, BoN's running log-probabilities, ST-BoN's divergence
tracking — while ``RequestState`` holds the method-agnostic host state
of one in-flight request (token log, done mask, RNG stream, token/byte
accounting). Two serving paths share them:

  * the single-request engine loop (``repro_torch.serving.engine``): one
    model step per iteration, cache rows gathered on compaction, one
    host transfer per step in :meth:`RequestState.sample_and_advance`;
  * the paged scheduler (``repro_torch.serving.scheduler``), which
    serves greedy and KAPPA, KAPPA's controller pooled across requests
    (:class:`PooledKappaController`).

Every host-side decision (sampling keys, masking, compaction order,
termination) lives here, as in the JAX package, which is what makes the
port's runs comparable with it token for token.
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
    # the strategy consumes each step's picked-token log-probs; the
    # engine loop then fetches them in the step's one host transfer
    wants_picked_lp = False

    def rows(self, kcfg: KappaConfig) -> int:
        return kcfg.num_branches

    def begin(self, params, cfg: ModelConfig, kcfg: KappaConfig, *,
              bos_id: int) -> None:
        self.kcfg = kcfg

    def init_done(self, tokens0: np.ndarray, eos_id: int) -> np.ndarray:
        return np.zeros(tokens0.shape, bool)

    def observe_prefill(self, picked_lp: Optional[np.ndarray]) -> None:
        """Observe the fan-out's first tokens: their log-probs under the
        prefill logits when the strategy wants them, else None."""

    def step(self, logits, in_tokens: np.ndarray, out_tokens: np.ndarray,
             branch_ids: np.ndarray, done: np.ndarray,
             done_prev: np.ndarray, step_idx: int,
             picked_lp: Optional[np.ndarray] = None) -> StepDecision:
        """Observe one decode step. ``logits`` are the rows' (rows, V)
        device logits of the step (None from the paged scheduler, whose
        strategies read none); ``out_tokens`` the just-sampled tokens,
        EOS for rows already done."""
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

    def step(self, logits, in_tokens, out_tokens, branch_ids, done,
             done_prev, step_idx, picked_lp=None):
        # the EOS token itself is logged/counted (emitted before done)
        return StepDecision(counted=~done_prev,
                            stop=bool(done[branch_ids[0]]))

    def decided_branch(self, branch_ids, done):
        return int(branch_ids[0])   # one branch; every token is final


class BoNStrategy(DecodeStrategy):
    """Full Best-of-N with negative-perplexity selection (Kang et al.
    2025): every branch decodes to EOS, keep the most likely one."""

    name = "bon"
    wants_picked_lp = True

    def begin(self, params, cfg, kcfg, *, bos_id):
        super().begin(params, cfg, kcfg, bos_id=bos_id)
        n = kcfg.num_branches
        self.sum_lp = np.zeros((n,), np.float64)
        self.count = np.zeros((n,), np.int64)

    def observe_prefill(self, picked_lp):
        self.sum_lp += picked_lp.astype(np.float64)
        self.count += 1

    def step(self, logits, in_tokens, out_tokens, branch_ids, done,
             done_prev, step_idx, picked_lp=None):
        step_lp = picked_lp.astype(np.float64)
        newly = ~done_prev  # a branch's own EOS step still counts toward ppl
        # index by branch id: after eager release the step arrays cover
        # only surviving rows, while sum_lp/count stay full fan-out
        self.sum_lp[branch_ids] += np.where(newly, step_lp, 0.0)
        self.count[branch_ids] += newly
        # release EOS'd branches eagerly: a done branch contributes
        # nothing further to its perplexity, so its rows go
        alive = ~done[branch_ids]
        keep = np.where(alive)[0] if alive.any() and not alive.all() else None
        return StepDecision(counted=newly, keep=keep, stop=bool(np.all(done)))

    def choose(self, branch_ids, done):
        return int(np.argmax(self._neg_ppl()))

    def decided_branch(self, branch_ids, done):
        # perplexity ranks over the FULL fan-out (eagerly-released EOS
        # branches included), so the winner can change until the last
        # branch finishes — undecided unless the fan-out is one
        return int(branch_ids[0]) if len(self.sum_lp) == 1 else None

    def _neg_ppl(self):
        return self.sum_lp / np.maximum(self.count, 1)

    def extra(self):
        return {"neg_ppl": self._neg_ppl().tolist()}


class STBoNStrategy(DecodeStrategy):
    """Self-Truncation BoN (Wang et al. 2025): decode until the earliest
    point of pairwise difference + a fixed buffer window, then keep the
    branch most consistent with the others and truncate the rest.

    Consistency = mean pairwise cosine similarity of the branches'
    buffer-window-averaged next-token distributions, as in the JAX
    package. The distributions are summed on the device in float64 (the
    reference sums the same float64 values on the host, element by
    element, so the sums are the same); the host reads the sum once,
    when it selects."""

    name = "stbon"

    def __init__(self, buffer_window: int = 16):
        self.buffer_window = buffer_window

    def begin(self, params, cfg, kcfg, *, bos_id):
        super().begin(params, cfg, kcfg, bos_id=bos_id)
        n = kcfg.num_branches
        self.diverged = np.eye(n, dtype=bool)
        self.cutoff_hit: Optional[int] = None
        self.prob_acc = torch.zeros((n, cfg.vocab_size), dtype=torch.float64,
                                    device=params["embed"].device)
        self.prob_cnt = 0
        self.truncated = False

    def step(self, logits, in_tokens, out_tokens, branch_ids, done,
             done_prev, step_idx, picked_lp=None):
        kcfg = self.kcfg
        keep = None
        if not self.truncated:
            self.diverged |= out_tokens[:, None] != out_tokens[None, :]
            if self.cutoff_hit is None and (np.all(self.diverged)
                                            or step_idx >= kcfg.max_cutoff):
                self.cutoff_hit = step_idx
            if self.cutoff_hit is not None:
                self.prob_acc += torch.softmax(logits.float(), dim=-1).double()
                self.prob_cnt += 1
                if step_idx >= self.cutoff_hit + self.buffer_window:
                    keep = np.array([int(np.argmax(self._consistency()))])
                    self.truncated = True
        bids = branch_ids if keep is None else branch_ids[keep]
        stop = (self.truncated and bool(done[bids[0]])) or bool(np.all(done[bids]))
        # EOS-emitting steps count (~done_prev), matching greedy/BoN —
        # a branch's own EOS token is part of its generated sequence
        return StepDecision(counted=~done_prev, keep=keep, stop=stop)

    def _consistency(self):
        # one read of the (N, V) sum at selection, not one per step
        # repro-lint: disable-next-line=sync-discipline
        prob_acc, = to_host(self.prob_acc)
        mean_p = prob_acc / max(self.prob_cnt, 1)
        norm = np.linalg.norm(mean_p, axis=-1, keepdims=True)
        unit = mean_p / np.maximum(norm, 1e-12)
        sim = unit @ unit.T
        n = prob_acc.shape[0]
        return (sim.sum(-1) - 1.0) / max(n - 1, 1)

    def choose(self, branch_ids, done):
        """If every branch hit EOS before ``cutoff + buffer_window``
        forced a truncation, select by the consistency accumulated so
        far; before any divergence (no signal accumulated) all branches
        are prefix-identical, so branch 0 is the tie-break."""
        if self.truncated:
            return int(branch_ids[0])
        if self.prob_cnt > 0:
            return int(branch_ids[int(np.argmax(self._consistency()))])
        return int(branch_ids[0])

    def decided_branch(self, branch_ids, done):
        # after self-truncation only the consistency winner survives and
        # choose() is pinned to it; before that the pick can still move
        return int(branch_ids[0]) if self.truncated else None

    def extra(self):
        return {"cutoff": self.cutoff_hit}


class KappaStrategy(DecodeStrategy):
    """The paper's KAPPA controller: latent-informativeness scoring with
    scheduled pruning and bucketed compaction (DESIGN.md §2).

    Two controller backends behind the same host-side decisions:

      * **local** (the single-request engine loop): this strategy owns
        its request's controller state and steps it with
        :func:`repro_torch.core.kappa.kappa_step` on the step's logits
        and just-sampled tokens, then reads (alive, traj) back; on
        compaction the state's rows are gathered with ``compact_state``.
      * **pooled** (the paged scheduler): the scheduler attaches a
        :class:`PooledKappaController` slot, the controller math runs in
        the scheduler's pooled dispatch, and this strategy reads its
        slot's slice of the published host mirrors. ``ctrl_rows`` maps
        the request's current (compaction-survivor) row order onto the
        slot's controller rows; compaction only shrinks the map (dropped
        rows are dead in the state).
    """

    name = "kappa"

    def begin(self, params, cfg, kcfg, *, bos_id):
        super().begin(params, cfg, kcfg, bos_id=bos_id)
        self._begin_args = (params, cfg, bos_id)
        # the local backend's controller state and reference log-probs,
        # made on first use (a pooled request never makes them)
        self.state: Optional[kappa_lib.KappaState] = None
        self.log_q = None
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

    def _local_state(self) -> kappa_lib.KappaState:
        if self._released:
            # result() must run BEFORE release_pool(); a fresh local
            # state here would report branch 0 / zero trajectories
            # instead of the pooled outcome
            raise RuntimeError(
                "KappaStrategy read after its pooled-controller slot was "
                "released — call result() before release_pool()")
        if self.state is None:
            params, cfg, bos_id = self._begin_args
            device = params["embed"].device
            self.log_q = bos_log_q(params, cfg, bos_id, device)
            self.state = kappa_lib.init_state(self.kcfg, device=device)
        return self.state

    def _alive_traj(self):
        if self.pool is not None:
            return (self.pool.alive[self.slot][self.ctrl_rows],
                    self.pool.traj[self.slot][self.ctrl_rows])
        st = self._local_state()
        # the local controller's outputs: one transfer for both
        # repro-lint: disable-next-line=sync-discipline
        return to_host(st.alive, st.traj)

    def step(self, logits, in_tokens, out_tokens, branch_ids, done,
             done_prev, step_idx, picked_lp=None):
        kcfg = self.kcfg
        if self.pool is None:
            # controller contract: ``tokens`` are the tokens JUST sampled
            # (out_tokens, EOS on rows already done)
            st = self._local_state()
            toks = torch.from_numpy(out_tokens).to(logits.device)
            self.state = kappa_lib.kappa_step(st, logits, toks, self.log_q,
                                              kcfg)
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
                if self.pool is not None:
                    self.ctrl_rows = self.ctrl_rows[keep]
                else:
                    self.state = kappa_lib.compact_state(
                        self.state, torch.from_numpy(keep).to(logits.device))
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
        if self.pool is not None:
            cutoff = int(self.pool.cutoff[self.slot])
            traj = self.pool.traj[self.slot][self.ctrl_rows]
        else:
            st = self._local_state()
            # repro-lint: disable-next-line=sync-discipline
            cut, traj = to_host(st.cutoff, st.traj)
            cutoff = int(cut)
        return {"cutoff": cutoff, "traj": traj.tolist()}


_STRATEGIES = {
    "greedy": GreedyStrategy,
    "bon": BoNStrategy,
    "stbon": STBoNStrategy,
    "kappa": KappaStrategy,
}


def make_strategy(name: str) -> DecodeStrategy:
    if name not in _STRATEGIES:
        raise ValueError(f"unknown method {name!r}; have {sorted(_STRATEGIES)}")
    return _STRATEGIES[name]()


# ----------------------------------------------------------- request state

class RequestState:
    """Method-agnostic host state of one in-flight request: RNG stream,
    done mask, token log, logical/compute/byte accounting. The scheduler
    owns the device cache and applies ``StepDecision.keep`` to its rows.

    ``rng`` is a key (2,) int64 as :func:`repro_torch.serving.rng.prng_key`
    makes it; the stream lives on the host."""

    def __init__(self, strategy: DecodeStrategy, params, cfg: ModelConfig,
                 kcfg: KappaConfig, prompt_len: int, rng, *, eos_id: int,
                 bos_id: int = 0, max_seq: int):
        self.strategy = strategy
        self.cfg = cfg
        self.kcfg = kcfg
        self.eos_id = eos_id
        self.max_seq = max_seq
        self.rng = rng.cpu()
        strategy.begin(params, cfg, kcfg, bos_id=bos_id)
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

    def _sample(self, logits) -> tuple:
        """Sample one token per live row with this step's keys; returns
        the device tokens, plus their log-probs when the strategy wants
        them, for the caller's one host transfer."""
        rows = logits.shape[0]
        keys = self.step_keys().to(logits.device)
        gmask = torch.full((rows,), self.strategy.greedy,
                           device=logits.device)
        toks = sampler.sample_rows(keys, logits, gmask, self.kcfg)
        if self.strategy.wants_picked_lp:
            return toks, sampler.picked_logprob(logits, toks)
        return (toks,)

    def first_tokens(self, pf_logits) -> np.ndarray:
        """Sample the fan-out tokens from the prefill logits (V,) — one
        host transfer at admission, as in the JAX package."""
        logits0 = pf_logits[None].expand(self.n, pf_logits.shape[-1])
        # the admission's one transfer (tokens, picked log-probs)
        # repro-lint: disable-next-line=sync-discipline
        cur, *picked = to_host(*self._sample(logits0))
        self.cur = cur.astype(np.int32)
        self.done = self.strategy.init_done(self.cur, self.eos_id)
        self.strategy.observe_prefill(picked[0] if picked else None)
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

    def sample_and_advance(self, logits) -> StepDecision:
        """Single-request path: one ``sample_rows`` call for this
        request's rows (``logits`` (rows, V) on the device), ONE host
        transfer of the sampled tokens (and, for a strategy that wants
        them, their log-probs), then the shared host-side bookkeeping."""
        toks, *picked = to_host(*self._sample(logits))
        return self.advance(logits, toks, picked[0] if picked else None)

    def advance(self, logits, tokens: np.ndarray,
                picked_lp: Optional[np.ndarray] = None) -> StepDecision:
        """Host-side work for one decode step given this request's rows'
        logits (the strategy's input; None from the paged scheduler) and
        pre-sampled next tokens (sampled with its :meth:`step_keys`).
        ``picked_lp`` carries the sampled tokens' log-probs for a
        strategy that wants them. The caller applies ``decision.keep``
        to its cache rows."""
        nxt_np = np.array(tokens, np.int32)
        done_prev = self.done[self.branch_ids].copy()
        nxt_np = np.where(done_prev, self.eos_id, nxt_np)
        self.done[self.branch_ids] |= (nxt_np == self.eos_id)
        self.pos += 1
        self.step += 1
        dec = self.strategy.step(logits, self.cur, nxt_np, self.branch_ids,
                                 self.done, done_prev, self.step,
                                 picked_lp=picked_lp)
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
