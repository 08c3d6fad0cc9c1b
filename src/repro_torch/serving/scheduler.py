"""Continuous-batching paged scheduler (DESIGN.md §4–§6).

:class:`PagedScheduler` serves many requests on one fixed pool of branch
rows whose global-attention KV lives in a shared page pool: each row
addresses it through a ``(max_pages,)`` block table, fan-out branches
share the fully-written prompt pages copy-on-write, and decode pages are
allocated lazily at page-boundary crossings. Per tick:

  * admit queued requests shortest-job-first (bounded bypass) into the
    PREFILLING state: a request owns its row slots and advances one
    ``prefill_chunk``-token chunk per tick, written straight into its
    pages; while rows decode, every chunk rides the tick's decode step
    (:func:`repro_torch.serving.engine.fused_decode_chunks`);
  * one decode step over the whole pool with per-row positions;
  * ONE sampling call for every active request's rows (per-row keys);
  * ONE pooled KAPPA-controller step for every active kappa request;
  * ONE host transfer carrying the sampled tokens and the controller's
    alive/traj/cutoff;
  * host-side advance of every request on its own rows: pruning frees
    rows (and their page references) immediately.

The host logic is the JAX package's, shared line for line with its
``PagedScheduler``; with the same per-request keys the two give the same
tokens. It serves greedy and KAPPA requests; BoN and ST-BoN run on the
single-request engine loop only. Not ported yet: the prefix cache, faults
and retry, cancellation / deadlines / shedding, streaming, int8 KV, and
preemption — the pool is sized so that pages never run out (``rows *
max_pages``), and running out raises instead of preempting.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import KappaConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_paged_cache, prefill_chunk
from repro_torch.models.transformer import check_supported
from repro_torch.serving import cache as cache_lib
from repro_torch.serving import engine, sampler, strategies
from repro_torch.serving.strategies import GenResult, to_host


# the methods whose strategies read no per-step logits: the tick hands
# every request its sampled tokens only
SCHEDULED_METHODS = ("greedy", "kappa")


class Unservable(ValueError):
    """Raised at ``submit()`` for a request this scheduler can never
    serve (more positions than ``max_seq``)."""


class PagesExhausted(RuntimeError):
    """The page pool ran dry. The JAX package preempts the youngest
    request here; preemption is not ported yet, and the default pool
    size never runs dry."""


@dataclasses.dataclass
class _Queued:
    rid: int
    prompt: np.ndarray
    rng: torch.Tensor
    need: int                  # prompt + max_new token slots
    fan_out: int
    bypasses: int = 0          # times a younger request was admitted first


@dataclasses.dataclass
class _Prefill:
    """A request in the PREFILLING state: it owns its row slots and the
    pages written so far (through slot[0]'s block table)."""
    item: _Queued
    slots: List[int]
    filled: int = 0            # prompt tokens written so far


class _SchedulerBase:
    """Queue, row-slot lifecycle and the fused tick, independent of how
    KV storage is reserved. Subclasses implement the storage policy."""

    def __init__(self, params, cfg: ModelConfig, kcfg: KappaConfig, *,
                 rows: int, max_seq: int, method: str = "kappa",
                 eos_id: int, bos_id: int = 0, prefill_chunk: int = 64,
                 device=None, clock: Optional[Callable[[], float]] = None):
        check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.kcfg = kcfg
        self.rows = rows
        self.max_seq = max_seq
        self.method = method
        self.eos_id = eos_id
        self.bos_id = bos_id
        self.device = resolve_device(device)
        if method not in SCHEDULED_METHODS:
            raise ValueError(
                f"method {method!r} is not served by the paged scheduler "
                f"yet (have {SCHEDULED_METHODS}); BoN and ST-BoN on it are "
                "a later slice of the port (ROADMAP queue 1)")
        need = strategies.make_strategy(method).rows(kcfg)
        if rows < need:
            raise ValueError(f"pool rows={rows} < request fan-out {need}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self.row_token = np.zeros((rows,), np.int32)
        self.row_pos = np.zeros((rows,), np.int32)
        self.free: List[int] = list(range(rows))
        self.queue: deque = deque()
        self.prefilling: Dict[int, _Prefill] = {}
        self._fused_rids: List[int] = []     # chunks riding this tick's
        self._fused_chunk_out = None         # decode step
        self.active: Dict[int, tuple] = {}   # rid -> (RequestState, slots)
        self._items: Dict[int, _Queued] = {}
        self._admit_seq: Dict[int, int] = {}
        self._admit_counter = 0
        self.results: Dict[int, GenResult] = {}
        self._next_rid = 0
        self.ticks = 0
        self._occupied_ticks = 0
        self._kappa_pool: Optional[strategies.PooledKappaController] = None
        # the ≤1-controller-step / ≤1-transfer-per-tick contract
        self.counters: Dict[str, int] = {
            "controller_dispatches": 0, "controller_syncs": 0,
            "sampler_dispatches": 0, "host_syncs": 0,
        }
        # injectable monotonic clock for the run's elapsed time
        self.clock: Callable[[], float] = clock or time.monotonic

    # ----------------------------------------------------- storage hooks

    def _admissible(self, item: _Queued) -> bool:
        raise NotImplementedError

    def _select_admit(self) -> Optional[int]:
        raise NotImplementedError

    def _release_storage(self, slots: List[int]) -> None:
        """Return the slots' KV reservation."""

    def _decode_tick(self):
        """One model step over the pool; returns the pool logits."""
        raise NotImplementedError

    def _prefill_step(self, pf: _Prefill):
        """Advance one prompt chunk; the last-position logits (V,) once
        the whole prompt is written, else None."""
        raise NotImplementedError

    def _finish_prefill(self, pf: _Prefill) -> None:
        """Share the prefilled storage across the fan-out."""
        raise NotImplementedError

    def _fuse_candidates(self) -> List[int]:
        return []

    def _post_tick_prefill(self) -> None:
        """Activate requests whose last chunk rode this tick's step."""

    def _account_pages_tick(self) -> None:
        """Page-usage accounting for ticks without a decode step."""

    # ------------------------------------------------------------ submit

    def submit(self, prompt: np.ndarray, rng: torch.Tensor) -> int:
        """Queue one prompt with its own RNG key
        (:func:`repro_torch.serving.rng.prng_key`); returns its id."""
        need = len(prompt) + self.kcfg.max_new_tokens
        if need > self.max_seq:
            raise Unservable(
                f"prompt needs {need} positions > pool max_seq={self.max_seq}")
        fan_out = strategies.make_strategy(self.method).rows(self.kcfg)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(_Queued(rid, np.array(prompt, np.int32), rng,
                                  need, fan_out))
        return rid

    # --------------------------------------------------------- admission

    def _admit_one(self) -> bool:
        idx = self._select_admit()
        if idx is None:
            return False
        item = self.queue[idx]
        del self.queue[idx]
        slots = sorted(self.free[:item.fan_out])
        del self.free[:item.fan_out]
        self._items[item.rid] = item
        self._admit_seq[item.rid] = self._admit_counter
        self._admit_counter += 1
        self.prefilling[item.rid] = _Prefill(item=item, slots=slots)
        return True

    def _start_request(self, item: _Queued, slots: List[int],
                       pf_logits) -> None:
        """Admission tail: build the RequestState, sample the fan-out's
        first tokens from the prefill logits, and activate the request
        (or, already finished, record its result)."""
        rs = strategies.RequestState(
            strategies.make_strategy(self.method), self.params, self.cfg,
            self.kcfg, len(item.prompt), item.rng, eos_id=self.eos_id,
            bos_id=self.bos_id, max_seq=self.max_seq)
        self._maybe_pool_controller(rs)
        rs.first_tokens(pf_logits)
        self.active[item.rid] = (rs, slots)
        if rs.finished:          # e.g. greedy whose first token is EOS
            self._finalize(item.rid)
        else:
            self.row_token[slots] = rs.cur
            self.row_pos[slots] = rs.pos

    def _maybe_pool_controller(self, rs: strategies.RequestState) -> None:
        if not isinstance(rs.strategy, strategies.KappaStrategy):
            return
        if self._kappa_pool is None:
            # slots = rows: every concurrent kappa request holds >= 1 row
            self._kappa_pool = strategies.PooledKappaController(
                self.params, self.cfg, self.kcfg, slots=self.rows,
                bos_id=self.bos_id, device=self.device)
        slot = self._kappa_pool.acquire(rs.n)
        rs.strategy.attach_pool(self._kappa_pool, slot, rs.n)

    def _advance_prefills(self) -> None:
        """Advance every PREFILLING request not riding the decode step by
        one standalone chunk (admission order); a request whose final
        chunk ran is finalized and activated in this tick."""
        self._fused_rids = self._fuse_candidates()
        fused = set(self._fused_rids)
        for rid in sorted(self.prefilling, key=lambda r: self._admit_seq[r]):
            if rid in fused:
                continue
            pf = self.prefilling[rid]
            with record_function("sched:standalone_chunk"):
                logits = self._prefill_step(pf)
            if logits is not None:
                self._finish_prefill(pf)
                del self.prefilling[rid]
                self._start_request(pf.item, pf.slots, logits)

    def _finalize(self, rid: int) -> None:
        """Record a finished request's result and release its resources
        (result() reads the pooled controller mirrors, so it comes first)."""
        self._items.pop(rid)
        self._admit_seq.pop(rid, None)
        rs, slots = self.active.pop(rid)
        self.results[rid] = rs.result()
        rs.strategy.release_pool()
        self._release(slots)

    def _release(self, slots: List[int]) -> None:
        self._release_storage(slots)
        self.row_token[slots] = 0
        self.row_pos[slots] = 0
        self.free.extend(slots)
        self.free.sort()

    # -------------------------------------------------------------- tick

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _pooled_kappa_dispatch(self, logits, toks_dev):
        """Advance every pooled kappa controller in one step; returns the
        device (alive, traj, cutoff), or None with no kappa request."""
        pool = self._kappa_pool
        if pool is None:
            return None
        pooled = [(rs, slots) for rs, slots in self.active.values()
                  if isinstance(rs.strategy, strategies.KappaStrategy)]
        if not pooled:
            return None
        gather_idx = np.zeros((pool.slots, pool.nmax), np.int32)
        done_prev = np.ones((pool.slots, pool.nmax), bool)
        for rs, slots in pooled:
            st = rs.strategy
            gather_idx[st.slot, st.ctrl_rows] = slots
            done_prev[st.slot, st.ctrl_rows] = rs.done[rs.branch_ids]
        self.counters["controller_dispatches"] += 1
        return pool.dispatch(logits, toks_dev, gather_idx, done_prev,
                             self.eos_id)

    def tick(self) -> None:
        """Admit what fits, advance PREFILLING requests, run one decode
        step over the pool (with the fused chunks), one sampling call,
        one pooled controller step, ONE host transfer, then advance every
        active request on its own rows (host work). Its phases are marked
        as ``sched:*`` ranges for ``torch.profiler``."""
        with record_function("sched:tick"):
            self._tick()

    def _tick(self) -> None:
        while self._admit_one():
            pass
        self._advance_prefills()
        if not self.active:
            if self.prefilling:
                self._occupied_ticks += self.rows - len(self.free)
                self._account_pages_tick()
                self.ticks += 1
            return
        self._occupied_ticks += self.rows - len(self.free)
        with record_function("sched:model_step"):
            logits = self._decode_tick()

        # one per-row-keyed sampling call for the whole pool; free rows
        # ride along as masked argmax (ignored)
        keys = torch.zeros((self.rows, 2), dtype=torch.int64)
        gmask = np.ones((self.rows,), bool)
        for rs, slots in self.active.values():
            keys[slots] = rs.step_keys()
            gmask[slots] = rs.strategy.greedy
        with record_function("sched:sampler"):
            toks_dev = sampler.sample_rows(keys.to(self.device), logits,
                                           self._dev(gmask), self.kcfg)
        self.counters["sampler_dispatches"] += 1
        # the pooled controller consumes the pool logits and the
        # just-sampled tokens on the device
        with record_function("sched:controller"):
            ctrl_dev = self._pooled_kappa_dispatch(logits, toks_dev)
        # ONE host transfer for the tokens and every controller output
        with record_function("sched:host_transfer"):
            host = to_host(toks_dev, *(ctrl_dev or ()))
        self.counters["host_syncs"] += 1
        toks = host[0].astype(np.int32)
        if ctrl_dev is not None:
            self.counters["controller_syncs"] += 1
            self._kappa_pool.publish(host[1:])

        for rid in list(self.active):
            rs, slots = self.active[rid]
            dec = rs.advance(None, toks[slots])
            if dec.keep is not None:
                kept = [slots[i] for i in dec.keep]
                self._release(sorted(set(slots) - set(kept)))
                slots = kept
                self.active[rid] = (rs, slots)
            self.row_token[slots] = rs.cur
            self.row_pos[slots] = rs.pos
            if rs.finished:
                self._finalize(rid)
        self._post_tick_prefill()
        self.ticks += 1

    # --------------------------------------------------------------- run

    def run(self) -> Dict[int, GenResult]:
        """Drive queue + pool to completion; returns rid -> GenResult."""
        t0 = self.clock()
        while self.queue or self.active or self.prefilling:
            before = (len(self.queue), len(self.active),
                      len(self.prefilling))
            self.tick()
            if not self.active and not self.prefilling and self.queue \
                    and (len(self.queue), 0, 0) == before:
                raise RuntimeError(
                    "scheduler stalled: queued request cannot be admitted "
                    f"(free={len(self.free)} rows)")
        self.elapsed = self.clock() - t0
        return dict(sorted(self.results.items()))

    # ----------------------------------------------------------- metrics

    def request_bytes(self) -> Dict[int, int]:
        """Per-request bytes currently referenced in the pool."""
        return cache_lib.per_request_bytes(
            self.cfg, {rid: (len(slots), rs.pos)
                       for rid, (rs, slots) in self.active.items()},
            self.max_seq)

    def throughput(self) -> Dict[str, float]:
        """Aggregate serving metrics over a completed ``run()``."""
        total_logical = sum(r.logical_tokens for r in self.results.values())
        total_compute = sum(r.compute_tokens for r in self.results.values())
        elapsed = max(getattr(self, "elapsed", 0.0), 1e-9)
        out = {
            "requests": len(self.results),
            "ticks": self.ticks,
            "time_s": elapsed,
            "logical_tokens": total_logical,
            "compute_tokens": total_compute,
            "tokens_per_s": total_logical / elapsed,
            "requests_per_s": len(self.results) / elapsed,
            "row_utilization": (self._occupied_ticks
                                / max(self.ticks * self.rows, 1)),
        }
        out.update(self.counters)
        return out


class PagedScheduler(_SchedulerBase):
    """Paged-pool scheduler (DESIGN.md §5).

    Parameters
    ----------
    rows : row slots (block tables / position vector entries); at least
        one request's fan-out.
    max_seq : upper bound on any request's ``prompt + max_new`` (rounded
        up to a page multiple).
    page_size : token slots per page (the CUDA kernel's K/V tile).
    prefill_chunk : prompt tokens a PREFILLING request advances per tick.
    device : where the pool and the model run (default ``cuda``).
    """

    # SJF aging bound: after this many bypasses the queue head is admitted
    # next-fit-or-nothing
    MAX_BYPASS = 4

    def __init__(self, params, cfg: ModelConfig, kcfg: KappaConfig, *,
                 rows: int, max_seq: int, page_size: int = 64,
                 method: str = "kappa", eos_id: int, bos_id: int = 0,
                 prefill_chunk: int = 64, device=None,
                 clock: Optional[Callable[[], float]] = None):
        max_seq = -(-max_seq // page_size) * page_size
        super().__init__(params, cfg, kcfg, rows=rows, max_seq=max_seq,
                         method=method, eos_id=eos_id, bos_id=bos_id,
                         prefill_chunk=prefill_chunk, device=device,
                         clock=clock)
        self.page_size = page_size
        self.max_pages = max_seq // page_size
        # every page sits in some row's table and a table holds at most
        # max_pages entries, so this pool can never run dry
        self.num_pages = rows * self.max_pages
        self.alloc = cache_lib.PageAllocator(self.num_pages, page_size,
                                             rows, self.max_pages)
        self.pool = init_paged_cache(cfg, self.num_pages, page_size,
                                     self.device)
        self.counters["fused_chunks"] = 0
        self.counters["decode_page_grows"] = 0   # lazy growth past a page
        self._page_ticks = 0                 # Σ pages in use over ticks
        self._page_peak = 0                  # max pages in use at any tick
        self._bt_dev = None                  # device block tables (cached)

    # --------------------------------------------------- page accounting

    def _shared_pages(self, item: _Queued) -> int:
        """Prompt pages shared by the whole fan-out (a single-branch
        request keeps its partial boundary page too)."""
        pos0 = len(item.prompt)
        if item.fan_out == 1:
            return self.alloc.pages_for(pos0)
        return pos0 // self.page_size

    def _boundary(self, item: _Queued) -> int:
        """1 if each branch needs a private COW copy of a mid-page prompt
        boundary, else 0."""
        if item.fan_out == 1:
            return 0
        return 1 if len(item.prompt) % self.page_size else 0

    def _initial_pages(self, item: _Queued) -> int:
        """Shared prompt pages once plus each branch's initial private
        pages (the boundary copy and one decode page, capped at what the
        branch can ever grow to)."""
        priv_worst = self.alloc.pages_for(item.need) - self._shared_pages(item)
        priv = min(1 + self._boundary(item), priv_worst)
        return self._shared_pages(item) + item.fan_out * priv

    def _admissible(self, item: _Queued) -> bool:
        return (len(self.free) >= item.fan_out
                and self.alloc.can_alloc(self._initial_pages(item)))

    def _select_admit(self) -> Optional[int]:
        # shortest-job-first among fitting requests, FIFO tie-break, with
        # bounded bypass so a short stream cannot starve the oldest
        if not self.queue:
            return None
        head = self.queue[0]
        if head.bypasses >= self.MAX_BYPASS:
            return 0 if self._admissible(head) else None
        best, best_need = None, None
        for i, item in enumerate(self.queue):
            if self._admissible(item) and (best is None
                                           or item.need < best_need):
                best, best_need = i, item.need
        if best is not None:
            for i in range(best):
                self.queue[i].bypasses += 1
        return best

    def _release_storage(self, slots) -> None:
        for s in slots:
            self.alloc.free_row(s)
        self._bt_dev = None

    def _grow_row(self, row: int) -> None:
        if not self.alloc.can_alloc(1):
            raise PagesExhausted(
                "page pool exhausted: preemption is not ported yet")
        if int(self.alloc.owned[row]) == 0:
            self.alloc.set_row_pages(row, self.alloc.alloc_pages(1))
        else:
            self.alloc.append_page(row)
        self._bt_dev = None

    def _ensure_pages(self) -> None:
        """Lazy growth: every active row whose position crossed into an
        unallocated logical page takes the next page (admission order)."""
        for rid in sorted(self.active, key=lambda r: self._admit_seq[r]):
            for s in self.active[rid][1]:
                lp = int(self.row_pos[s]) // self.page_size
                while int(self.alloc.owned[s]) <= lp:
                    self._grow_row(s)
                    self.counters["decode_page_grows"] += 1

    # ------------------------------------------------- chunked prefill

    def _grow_for_chunk(self, pf: _Prefill) -> int:
        """Acquire the pages covering the next chunk; returns its length."""
        s0 = pf.slots[0]
        c = min(self.prefill_chunk, len(pf.item.prompt) - pf.filled)
        need = self.alloc.pages_for(pf.filled + c)
        while int(self.alloc.owned[s0]) < need:
            self._grow_row(s0)
        return c

    def _chunk_args(self, pf: _Prefill, c: int):
        """Device operands of one chunk: tokens, pos0, the PREFIX of
        slot[0]'s block table covering the filled prompt, and the
        physical page of every chunk token."""
        s0 = pf.slots[0]
        piece = pf.item.prompt[pf.filled:pf.filled + c]
        qpos = np.arange(pf.filled, pf.filled + c)
        cpages = self.alloc.block[s0][qpos // self.page_size]
        width = self.alloc.pages_for(pf.filled + c)
        return (self._dev(piece.astype(np.int64))[None],
                self._dev(np.array([pf.filled], np.int32)),
                self._dev(np.ascontiguousarray(self.alloc.block[s0:s0 + 1,
                                                                :width])),
                self._dev(cpages.astype(np.int32))[None])

    def _prefill_step(self, pf: _Prefill):
        """Standalone chunk — used when no decode step runs this tick."""
        c = self._grow_for_chunk(pf)
        toks, pos0, bt, cpages = self._chunk_args(pf, c)
        logits, self.pool = prefill_chunk(self.params, self.cfg, toks, pos0,
                                          self.pool, bt, cpages)
        pf.filled += c
        return logits[0] if pf.filled >= len(pf.item.prompt) else None

    def _finish_prefill(self, pf: _Prefill) -> None:
        """slot[0] keeps its table (it wrote the pages); siblings alias the
        full prompt pages and get a private device copy of the mid-page
        boundary, their COW write target."""
        item, s0 = pf.item, pf.slots[0]
        n = item.fan_out
        pos0 = len(item.prompt)
        full = pos0 // self.page_size
        boundary = self._boundary(item)
        if n > 1:
            need = boundary * (n - 1)
            if not self.alloc.can_alloc(need):
                raise PagesExhausted(
                    "page pool exhausted: preemption is not ported yet")
            shared = [int(p) for p in self.alloc.block[s0, :full]]
            copies: List[int] = []
            if boundary:
                b_src = int(self.alloc.block[s0, full])
                copies = self.alloc.alloc_pages(need)
                cache_lib.copy_pages(self.pool, [b_src] * need, copies)
            for i, s in enumerate(pf.slots[1:]):
                self.alloc.set_row_pages(
                    s, shared + ([copies[i]] if boundary else []))
        self._bt_dev = None

    def _fuse_candidates(self) -> List[int]:
        # every PREFILLING request rides the decode step when one runs
        if not self.active or not self.prefilling:
            return []
        return sorted(self.prefilling, key=lambda r: self._admit_seq[r])

    def _account_pages_tick(self) -> None:
        self._page_ticks += self.alloc.used_count
        self._page_peak = max(self._page_peak, self.alloc.used_count)

    def _decode_tick(self):
        # grow every fused chunk's pages first, then the decode rows'
        fused = [(rid, self.prefilling[rid],
                  self._grow_for_chunk(self.prefilling[rid]))
                 for rid in self._fused_rids]
        self._ensure_pages()
        # COW guard: every active row's write page must be refcount-1
        wp = np.full((self.rows,), self.alloc.trash, np.int32)
        occ = np.array([s for _, slots in self.active.values()
                        for s in slots], np.int64)
        if occ.size:
            wp[occ] = self.alloc.write_page(occ, self.row_pos[occ])
        self._account_pages_tick()
        if self._bt_dev is None:
            self._bt_dev = self._dev(self.alloc.block.copy())
        self.counters["fused_chunks"] += len(fused)
        chunks = [self._chunk_args(pf, c) for _, pf, c in fused]
        logits, clogits, self.pool = engine.fused_decode_chunks(
            self.params, self.cfg, self._dev(self.row_token.astype(np.int64)),
            self._dev(self.row_pos), self.pool, self._bt_dev, self._dev(wp),
            chunks)
        out = {}
        for (rid, pf, c), cl in zip(fused, clogits):
            pf.filled += c
            out[rid] = cl
        self._fused_chunk_out = out
        return logits

    def _post_tick_prefill(self) -> None:
        rids, self._fused_rids = self._fused_rids, []
        out, self._fused_chunk_out = self._fused_chunk_out, None
        if not rids or out is None:
            return
        for rid in rids:
            pf = self.prefilling[rid]
            if pf.filled < len(pf.item.prompt):
                continue
            self._finish_prefill(pf)
            del self.prefilling[rid]
            # rows join the NEXT decode tick
            self._start_request(pf.item, pf.slots, out[rid][0])

    # ----------------------------------------------------------- metrics

    def request_bytes(self) -> Dict[int, int]:
        """Per-request bytes from allocator truth: pages the request's
        rows reference (shared prompt pages once) times the page bytes."""
        pb = cache_lib.page_bytes(self.cfg, self.page_size)
        return {rid: len({int(p) for s in slots
                          for p in self.alloc.row_pages(s)}) * pb
                for rid, (rs, slots) in self.active.items()}

    def throughput(self) -> Dict[str, float]:
        out = super().throughput()
        out["pool_bytes"] = cache_lib.cache_bytes(self.pool)
        out["page_utilization"] = (self._page_ticks
                                   / max(self.ticks * self.num_pages, 1))
        out["page_peak"] = self._page_peak
        out["decode_page_grows"] = self.counters["decode_page_grows"]
        return out
