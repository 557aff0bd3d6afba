"""Continuous-batching engines (model-agnostic half): the slot pool
and the paged KV arena that replaced it as the serving default.

The dispatch-per-group serve loop ran one whole ``generate`` per
micro-batch: a request arriving one step after a dispatch started
waited the FULL previous generation before its prefill even began,
and every row padded out to the group's longest generation.
``SlotEngine`` replaces that loop with per-step scheduling over a
persistent slot pool; ``PagedEngine`` further replaces
the pool's row carve with a page-budgeted arena — block-granular KV
through per-request page tables, chunked prefill interleaved with
decode, refcounted prefix caching (serve/paging.py) — while sharing
this loop's admission/retirement/telemetry machinery and keeping
greedy outputs token-identical.  The slot-pool shape:

* the KV cache is allocated ONCE at ``SLOTS x max_len`` (static
  shapes — XLA never recompiles as occupancy changes);
* waiting requests are admitted into free slots at EVERY decode step
  (prefill-into-slot, models/decode.py), so p95 time-to-first-token is
  O(one decode tick + own prefill) instead of O(a whole generation);
* finished rows (per-row EOS / max-token / cache-exhausted) retire
  their slot IMMEDIATELY — the pool never pads a short answer out to
  the longest row, which is where the mean-to-max generation-length
  throughput win comes from (bench.py bench_continuous_serve).

The engine is model-agnostic and jax-free: the device half is two
injected callables (the single-chip server binds them straight to a
``serve.pool.PoolModel``; the gang driver wraps them in ADMIT/DECODE
broadcast ticks so every rank steps the same program).  Liveness
rules inherited from ``utils/microbatch.py`` (which this subsumes for
both servers): FIFO admission order, queue-timeout removal (abandoned
work never reaches the chip — an active abandoned row retires at the
next tick, freeing its slot early), and an ``on_idle`` hook so an
SPMD gang keeps meeting in collectives with no traffic.

Serving load telemetry: ``stats()`` reports queue depth, active
slots, KV occupancy, tokens/s and TTFT percentiles; ``
register_metrics`` exports the gauges through a metrics registry
(StatsD/Prometheus), and ``stats_path`` mirrors them to
``servestats.json`` in the task sandbox, where the scheduler's
``GET /v1/debug/serving`` collects them per pod — the load signal
the health plane reads for scale-out decisions.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np

from dcos_commons_tpu_torch.trace.ranges import profiled
from dcos_commons_tpu_torch.utils.microbatch import QueueTimeoutError

SERVESTATS_NAME = "servestats.json"
_TTFT_WINDOW = 512      # TTFT samples kept for the percentile gauges
_RATE_WINDOW_S = 10.0   # tokens/s sliding window


class _Group:
    """One ``submit()`` call: N rows answered together."""

    __slots__ = ("rows", "remaining", "done", "error", "abandoned")

    def __init__(self, rows: List["_Row"]):
        self.rows = rows
        self.remaining = len(rows)
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.abandoned = False


class _Row:
    """One prompt riding one KV slot."""

    __slots__ = (
        "tokens", "n", "temp", "eos", "seed", "out", "group",
        "arrival", "slot", "rid", "frozen",
    )

    def __init__(self, tokens, n, temp, eos, seed, group):
        self.tokens = tokens
        self.n = n
        self.temp = temp
        self.eos = eos
        self.seed = seed
        self.out: List[int] = []
        self.group = group
        self.arrival = time.monotonic()
        self.slot = -1
        # migration identity/fence (serve/migration.py):
        # rid is the pod-local session id; a frozen row holds its
        # slot and pages but is excluded from every dispatch until
        # unfrozen, released to a peer, or activated after a splice
        self.rid = -1
        self.frozen = False


class SlotEngine:
    """Admission loop over a persistent slot-pool KV cache.

    ``prefill_fn(padded [1, prompt_len] i32, slot=, true_len=, temp=,
    seed=) -> first token`` runs one prompt into a pool row (the
    scalars are passed by KEYWORD — transposing slot and true_len is
    a silent cache corruption);
    ``decode_fn(tok [S] i32, pos [S] i32, temps [S] f32, seeds [S]
    i32, n_active) -> next tokens [S] i32`` advances EVERY row one
    step (inactive rows are parked at slot state (0, 0) — their
    computation is discarded and their cache row is fully overwritten
    by the next admission's prefill).  Both run OUTSIDE the engine
    lock; only host-side bookkeeping holds it.
    """

    _row_cls = _Row
    # gauges register_metrics exports (subclasses extend)
    METRIC_KEYS = (
        "queue_depth", "active_slots", "kv_occupancy", "tokens_per_s",
    )

    def __init__(
        self,
        prefill_fn: Callable,
        decode_fn: Callable,
        slots: int,
        max_len: int,
        prompt_len: int,
        queue_timeout_s: float = 600.0,
        on_idle: Optional[Callable[[], None]] = None,
        idle_every_s: float = 0.05,
        stats_path: Optional[str] = None,
        stats_every_s: float = 1.0,
        log: Optional[Callable[[str], None]] = None,
        extra_stats: Optional[dict] = None,
    ):
        if slots < 1:
            raise ValueError(f"slot pool needs >= 1 slot, got {slots}")
        self._prefill_fn = prefill_fn
        self._decode_fn = decode_fn
        self._slots = slots
        self._max_len = max_len
        self._prompt_len = prompt_len
        self._queue_timeout_s = queue_timeout_s
        self._on_idle = on_idle
        self._idle_every_s = idle_every_s
        self._stats_path = stats_path
        self._stats_every_s = stats_every_s
        self._log = log

        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._rows: List[Optional[_Row]] = [None] * slots
        self._free = list(range(slots - 1, -1, -1))  # pop() -> slot 0 first
        self._active = 0
        self._tok = np.zeros(slots, np.int32)
        self._pos = np.zeros(slots, np.int32)
        self._temps = np.zeros(slots, np.float32)
        self._seeds = np.zeros(slots, np.int32)
        self._stopped = False
        self._next_rid = 1  # session ids (migration's addressing unit)
        # telemetry (counters under the cv; deques pruned on append)
        self._admitted = 0
        self._completed = 0
        self._timeouts = 0
        self._timeouts_by_kind: dict = {}
        self._tokens_out = 0
        self._ttft: deque = deque(maxlen=_TTFT_WINDOW)
        self._rate: deque = deque()  # (monotonic, tokens) per tick
        self._merge_logged = False
        self._stats_written = 0.0  # loop-thread only
        # stats consumers may annotate the snapshot with facts the
        # engine cannot know (the worker's actually-bound HTTP port:
        # the /v1/endpoints advertisement).  Constructor-
        # passed extras precede the loop thread's first flush, so the
        # sandbox snapshot carries them from its very first write
        self._extra_stats: dict = dict(extra_stats or {})
        # loop-liveness stamp for the stats_age_s gauge: the router
        # and HealthMonitor discard gauges whose engine stopped
        # ticking instead of balancing on a wedged pod's last-good
        # numbers.  Stamped at every loop wake AND at submit-time
        # enqueue (an idle engine is trivially responsive — its age
        # must start at the arrival, not at the end of the idle gap)
        self._last_tick_mono = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name="slot-engine", daemon=True
        )
        self._thread.start()

    # -- client surface ----------------------------------------------

    def submit(
        self,
        rows: Sequence[Sequence[int]],
        max_new_tokens: int,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
    ) -> List[List[int]]:
        """Queue ``rows`` (each its own slot, admitted independently
        as slots free up — a multi-row request may overlap several
        pool generations) and block until every row finished.  Raises
        ``QueueTimeoutError`` on saturation (handlers map it to 503),
        ``ValueError`` on caller error (400)."""
        if not rows:
            raise ValueError("tokens must be non-empty")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        for row in rows:
            if len(row) < 1:
                raise ValueError("prompts must be non-empty")
            if len(row) > self._prompt_len:
                raise ValueError(
                    f"prompt length {len(row)} exceeds the server's "
                    f"context {self._prompt_len}"
                )
            if len(row) + max_new_tokens > self._max_len:
                raise ValueError(
                    f"prompt {len(row)} + {max_new_tokens} new tokens "
                    f"cannot fit the {self._max_len}-position slot"
                )
        group = _Group([])
        group.rows = [
            self._row_cls(
                [int(t) for t in row], max_new_tokens, float(temperature),
                eos_id,
                int.from_bytes(os.urandom(4), "little") % (2 ** 31),
                group,
            )
            for row in rows
        ]
        group.remaining = len(group.rows)
        with self._cv:
            now = time.monotonic()
            if not self._has_work_locked():
                # idle -> working transition: liveness is measured
                # from THIS arrival, not across the idle gap
                self._last_tick_mono = now
            for r in group.rows:
                r.rid = self._next_rid
                self._next_rid += 1
            self._queue.extend(group.rows)
            self._cv.notify_all()
        # the timeout bounds SATURATION, not a healthy generation: a
        # window with no row admitted (starved for a slot) or no new
        # token across the whole group (the pool stalled) abandons;
        # an admitted group that keeps producing is never cut off
        # mid-generation just for being long
        last_progress = -1
        while not group.done.wait(timeout=self._queue_timeout_s):
            with self._cv:
                admitted = any(r.slot >= 0 for r in group.rows)
                progress = self._progress_locked(group)
                if admitted and progress > last_progress:
                    last_progress = progress
                    continue
                # abandoned work never reaches the chip: queued rows
                # leave the queue NOW; already-active rows retire at
                # the next tick, freeing their slots early instead of
                # decoding a dead request to completion
                group.abandoned = True
                self._queue = deque(
                    r for r in self._queue if r.group is not group
                )
                reason, kind = self._timeout_reason_locked(
                    group, admitted
                )
                self._timeouts += 1
                self._timeouts_by_kind[kind] = (
                    self._timeouts_by_kind.get(kind, 0) + 1
                )
            raise QueueTimeoutError(reason, kind=kind)
        if group.error is not None:
            raise group.error
        return [list(r.out) for r in group.rows]

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=10)

    def _progress_locked(self, group: _Group) -> int:
        """Monotone per-group progress measure for the timeout loop
        (tokens produced; the paged engine adds prefilled positions —
        a long prompt mid-chunked-prefill IS making progress)."""
        return sum(len(r.out) for r in group.rows)

    def _timeout_reason_locked(self, group, admitted: bool):
        """(reason string, QueueTimeoutError kind) for a timed-out
        group — the 503 body and the split timeout counters."""
        if not admitted:
            return "request timed out waiting for a KV slot", "kv-slot"
        return (
            f"no decode progress in {self._queue_timeout_s}s", "stalled"
        )

    # -- telemetry ---------------------------------------------------

    def annotate_stats(self, **extra) -> None:
        """Attach static facts to every future ``stats()`` snapshot
        (the worker's actually-bound ``http_port``; anything the
        engine itself cannot know).  Keys must not collide with the
        engine's own gauges."""
        with self._cv:
            self._extra_stats.update(extra)

    def stats(self) -> dict:
        """Serving-load snapshot (the per-pod gauges the health plane
        names as the scale-out signal)."""
        now = time.monotonic()
        with self._cv:
            # loop-liveness stamp: 0 while idle (a parked loop is
            # trivially responsive; admission wakes it), else the
            # time since the loop last proved alive — the wedge
            # signal the router's staleness gate keys on
            stats_age = (
                max(0.0, now - self._last_tick_mono)
                if self._has_work_locked() else 0.0
            )
            live_tokens = self._live_tokens_locked()
            window = [n for (t, n) in self._rate
                      if t > now - _RATE_WINDOW_S]
            ttft = sorted(self._ttft)
            kinds = self._timeouts_by_kind
            out = {
                "slots": self._slots,
                "max_len": self._max_len,
                "queue_depth": len(self._queue),
                "active_slots": self._active,
                "free_slots": len(self._free),
                "kv_live_tokens": live_tokens,
                "kv_occupancy": round(
                    live_tokens / float(self._kv_capacity()), 4
                ),
                "tokens_per_s": round(
                    sum(window) / _RATE_WINDOW_S, 2
                ),
                "requests_admitted": self._admitted,
                "requests_completed": self._completed,
                "requests_timed_out": self._timeouts,
                # the saturation split (utils/microbatch.py kinds):
                # memory = the paged arena's page budget never fit;
                # compute = no decode row freed / admitted but stalled
                "requests_timed_out_memory": kinds.get(
                    "kv-page-budget", 0
                ),
                "requests_timed_out_compute": (
                    kinds.get("kv-slot", 0) + kinds.get("stalled", 0)
                ),
                "tokens_out": self._tokens_out,
            }
            out["stats_age_s"] = round(stats_age, 4)
            out.update(self._stats_extra_locked())
            out.update(self._extra_stats)
        if ttft:
            from dcos_commons_tpu_torch.metrics.registry import percentile

            out["ttft_p50_s"] = round(percentile(ttft, 50), 4)
            out["ttft_p95_s"] = round(percentile(ttft, 95), 4)
        out["t"] = time.time()
        return out

    def _live_tokens_locked(self) -> int:
        return int(sum(
            int(self._pos[s])
            for s, row in enumerate(self._rows) if row is not None
        ))

    def _kv_capacity(self) -> int:
        """KV positions the cache can hold (the occupancy basis)."""
        return self._slots * self._max_len

    def _stats_extra_locked(self) -> dict:
        return {}

    def register_metrics(self, metrics, prefix: str = "serving") -> None:
        """Export the load gauges through a metrics registry
        (metrics/registry.py): queue depth, active slots, KV
        occupancy, tokens/s — scraped as gauges / pushed via StatsD
        (the paged engine adds page-budget and prefix-cache gauges)."""
        for key in self.METRIC_KEYS:
            metrics.gauge(
                f"{prefix}.{key}",
                lambda key=key: self.stats()[key],
            )

    # -- the loop ----------------------------------------------------

    def _loop(self) -> None:
        # persists across iterations: the on_idle servers (gang) pass
        # through the outer loop once per idle TICK, and the terminal
        # flush must happen once per idle PERIOD, not at 20 Hz forever
        flushed_idle = False
        while True:
            idle = False
            flush_now = False
            admits: List[_Row] = []
            with profiled("engine.schedule"), self._cv:
                self._last_tick_mono = time.monotonic()
                while not self._has_work_locked() and not self._stopped:
                    if not flushed_idle:
                        # flush the terminal snapshot before parking:
                        # an idle server's LAST burst must be visible
                        # to /v1/debug/serving, not its second-to-last.
                        # The write itself happens OUTSIDE the lock —
                        # file IO on a slow sandbox must not block
                        # submit() callers needing the cv
                        flushed_idle = True
                        flush_now = True
                        break
                    if self._on_idle is None:
                        self._cv.wait()
                        self._last_tick_mono = time.monotonic()
                    else:
                        self._cv.wait(timeout=self._idle_every_s)
                        self._last_tick_mono = time.monotonic()
                        if not self._has_work_locked():
                            break  # fire on_idle OUTSIDE the lock
                if self._stopped:
                    return
                idle = not self._has_work_locked()
                if not idle:
                    flushed_idle = False  # work resumed: re-arm
                    admits = self._pop_admits_locked()
            if flush_now:
                self._write_stats(force=True)
                continue
            if idle:
                self._safe_idle()
                continue
            try:
                with profiled("engine.tick"):
                    self._work_tick(admits)
                self._write_stats()
            except Exception as e:  # noqa: BLE001 — fail FAST, not silent
                # a bookkeeping bug (bad decode shape, broken stats
                # path) must not kill this thread silently: every
                # client would then block its full timeout and the
                # gang's followers would wedge in a stale collective.
                # Fan the error out and keep the loop alive.
                with self._cv:
                    self._fail_all_locked(e)

    def _has_work_locked(self) -> bool:
        return bool(self._queue) or self._active > 0

    def _work_tick(self, admits: List[_Row]) -> None:
        """One scheduling round (loop thread, OUTSIDE the cv): admit,
        then advance every active row one decode step."""
        self._admit_all(admits)
        if self._active:  # loop thread is the only writer
            self._decode_tick()

    def _pop_admits_locked(self) -> List[_Row]:
        """FIFO admission: oldest waiting rows take the free slots —
        a row can never starve behind later arrivals."""
        admits: List[_Row] = []
        while self._queue and self._free:
            row = self._queue.popleft()
            if row.group.abandoned:
                continue
            row.slot = self._free.pop()
            admits.append(row)
        return admits

    def _admit_all(self, admits: List[_Row]) -> None:
        for i, row in enumerate(admits):
            padded = np.zeros((1, self._prompt_len), np.int32)
            padded[0, : len(row.tokens)] = row.tokens
            try:
                first = int(self._prefill_fn(
                    padded, slot=row.slot, true_len=len(row.tokens),
                    temp=row.temp, seed=row.seed,
                ))
            except Exception as e:  # noqa: BLE001 — fan out, keep serving
                with self._cv:
                    # the popped-but-not-installed rows (this one and
                    # the rest of the batch) are invisible to both the
                    # queue and the active set: return their slots and
                    # fail their groups explicitly, or each failure
                    # would leak a slot and leave its client waiting
                    # out the full timeout for a model error
                    for r in admits[i:]:
                        self._free.append(r.slot)
                        r.slot = -1
                    self._fail_all_locked(
                        e, extra_groups={r.group for r in admits[i:]}
                    )
                return
            now = time.monotonic()
            with self._cv:
                self._apply_admit_locked(row, first, now)

    def _apply_admit_locked(self, row: _Row, first: int, now: float):
        self._admitted += 1
        self._ttft.append(now - row.arrival)
        row.out.append(first)
        self._count_tokens_locked(1, now)
        if self._row_finished(row, first, int(len(row.tokens))):
            self._retire_locked(row)
            return
        self._install_decode_locked(row)

    def _install_decode_locked(self, row: _Row) -> None:
        """Enter ``row`` into the decode set at its current progress
        — a fresh admission (out == [first]) and a spliced-in
        migrated session (out carries every token so far) resume
        through the same door: decode continues from (out[-1],
        plen + len(out) - 1), wherever that state was produced."""
        slot = row.slot
        self._rows[slot] = row
        self._active += 1
        self._tok[slot] = row.out[-1]
        self._pos[slot] = len(row.tokens) + len(row.out) - 1
        self._temps[slot] = row.temp
        self._seeds[slot] = row.seed

    _MERGE_NOUN = "slot pool"

    def _decode_prep_locked(self) -> tuple:
        """Extra positional args for ``decode_fn`` (before
        ``n_active``), prepared under the cv — the paged engine
        allocates write pages and snapshots the page tables here."""
        return ()

    def _decode_tick(self) -> None:
        with self._cv:
            extra = self._decode_prep_locked()
            active = self._active
            # who this tick actually computes for: a row installed
            # into a slot AFTER this point (a splice activation or a
            # migration-abort unfreeze, both peer threads) must not
            # be credited this tick's sample — it was computed from
            # the slot's previous state.  Frozen rows count as
            # not-dispatched: their table was zeroed above, so the
            # sample is trash even if they unfreeze mid-tick.
            dispatched = [
                r if (r is not None and not r.frozen) else None
                for r in self._rows
            ]
        try:
            nxt = np.asarray(self._decode_fn(
                self._tok.copy(), self._pos.copy(),
                self._temps.copy(), self._seeds.copy(),
                *extra, active,
            ))
        except Exception as e:  # noqa: BLE001 — fan out, keep serving
            with self._cv:
                self._fail_all_locked(e)
            return
        now = time.monotonic()
        merged = None
        with self._cv:
            self._apply_decode_locked(nxt, now, dispatched)
            if self._active >= 2 and not self._merge_logged:
                self._merge_logged = True
                merged = self._active
            elif self._active <= 1:
                self._merge_logged = False
        if merged is not None and self._log is not None:
            self._log(
                f"continuous-batch: {merged} rows sharing one decode "
                f"step over the {self._MERGE_NOUN}"
            )

    def _apply_decode_locked(self, nxt: np.ndarray, now: float,
                             dispatched=None) -> None:
        produced = 0
        for slot in range(self._slots):
            row = self._rows[slot]
            if row is None:
                continue
            if dispatched is not None and dispatched[slot] is not row:
                # not this tick's row (installed or unfrozen mid-tick
                # by a migration thread): its first real sample is
                # next tick's
                continue
            if row.frozen:
                # fenced for migration: this tick dispatched it with
                # a zero (trash) table row, so the sampled token is
                # discarded and (tok, pos) stand still — decode
                # resumes from the exact frozen state on whichever
                # pod ends up owning the session
                continue
            if row.group.abandoned:
                self._retire_locked(row)
                continue
            token = int(nxt[slot])
            row.out.append(token)
            produced += 1
            self._pos[slot] += 1
            self._tok[slot] = token
            if (self._row_finished(row, token, int(self._pos[slot]))):
                self._retire_locked(row)
        self._count_tokens_locked(produced, now)

    def _row_finished(self, row: _Row, token: int, pos: int) -> bool:
        return (
            len(row.out) >= row.n
            or (row.eos is not None and token == row.eos)
            or pos >= self._max_len  # slot cache exhausted
        )

    def _retire_locked(self, row: _Row) -> None:
        slot = row.slot
        if self._rows[slot] is row:
            self._rows[slot] = None
            self._active -= 1
            self._tok[slot] = 0
            self._pos[slot] = 0
            self._temps[slot] = 0.0
            self._seeds[slot] = 0
        self._free.append(slot)
        group = row.group
        group.remaining -= 1
        if group.remaining <= 0 and not group.abandoned:
            self._completed += 1
            group.done.set()

    def _fail_all_locked(
        self, error: BaseException, extra_groups=(),
    ) -> None:
        """A model-call failure fans out to every waiting and active
        request (the MicroBatcher contract) and clears the pool.
        ``extra_groups``: groups of rows in admission limbo (popped
        from the queue, not yet installed in the pool) — the caller
        has already returned their slots."""
        groups = {r.group for r in self._queue}
        groups |= {r.group for r in self._rows if r is not None}
        groups |= set(extra_groups)
        self._queue.clear()
        for slot, row in enumerate(self._rows):
            if row is not None:
                self._rows[slot] = None
                self._active -= 1
                self._free.append(slot)
        self._tok[:] = 0
        self._pos[:] = 0
        self._temps[:] = 0.0
        self._seeds[:] = 0
        for group in groups:
            group.error = error
            group.done.set()

    def _count_tokens_locked(self, n: int, now: float) -> None:
        if n <= 0:
            return
        self._tokens_out += n
        self._rate.append((now, n))
        while self._rate and self._rate[0][0] < now - _RATE_WINDOW_S:
            self._rate.popleft()

    def _safe_idle(self) -> None:
        try:
            self._on_idle()
        except Exception:  # noqa: BLE001, sdklint: disable=swallowed-exception — idle hook must not kill serving
            pass

    def _write_stats(self, force: bool = False) -> None:
        """Mirror the gauges to the sandbox (loop thread only): the
        scheduler's /v1/debug/serving reads this per task."""
        if self._stats_path is None:
            return
        now = time.monotonic()
        if not force and now - self._stats_written < self._stats_every_s:
            return
        self._stats_written = now
        try:
            tmp = self._stats_path + ".tmp"
            # durcheck: dur-file-discipline=telemetry mirror: loss on power failure is acceptable, the rename alone keeps readers partial-free
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.stats(), f)
            os.replace(tmp, self._stats_path)
        except OSError:
            pass  # sdklint: disable=swallowed-exception — telemetry must never take the server down


class _PagedRow(_Row):
    """A request riding a PAGE TABLE instead of a contiguous slot row
    (serve/paging.py): ``table[v]`` is the physical arena page holding
    virtual positions ``[v*P, (v+1)*P)``; 0 = unallocated."""

    __slots__ = (
        "table", "fill_pos", "admission", "private_pages",
        "registered_to",
    )

    def __init__(self, tokens, n, temp, eos, seed, group):
        super().__init__(tokens, n, temp, eos, seed, group)
        self.table = None            # np.int32 [M], built at admission
        self.fill_pos = 0            # next prompt position to prefill
        self.admission = None        # paging.Admission while admitted
        self.private_pages: List[int] = []
        self.registered_to = 0       # next prompt page to publish


class PagedEngine(SlotEngine):
    """Continuous batching over a PAGED KV arena: block-granular
    allocation, chunked prefill, and prefix caching (the paged
    tentpole; vLLM's PagedAttention + SGLang's RadixAttention shape).

    Differences from the slot pool it replaces:

    * **Admission is page-budgeted** (serve/paging.py): a request
      enters the pool only when a free decode row exists AND its
      worst-case page need fits ``available - reserved`` — admitted
      work can never OOM mid-generation, and a short reply returns
      its unused pages immediately instead of stranding a MAX_LEN
      row.  FIFO stays strict: a budget-blocked head is never jumped
      by a smaller later request.
    * **Prefill is chunked**: prompts run ``chunk_tokens`` at a time
      — one chunk per PREFILLING REQUEST per engine tick, interleaved
      with decode — so a long prompt no longer blocks the tick it
      rides and queued requests stop paying head-of-line TTFT.
      Chunk progress counts as progress for the 503 timeout (a long
      prefill is not a stall).
    * **Prefix caching**: fully-prefilled prompt pages are published
      read-only; an identical later prefix pins them instead of
      recomputing (COW-by-recompute on mid-page divergence — shared
      pages are never written; see serve/paging.py).

    ``prefill_chunk_fn(padded [1, C] i32, slot=, table= [M] i32,
    start=, true_len=, temp=, seed=) -> first token`` runs one chunk
    (the return value is consumed only when the chunk completes the
    prompt); ``decode_fn(tok [S], pos [S], temps [S], seeds [S],
    tables [S, M] i32, n_active) -> next tokens [S]`` advances every
    row through its page table.  Scalars by KEYWORD, as ever.
    """

    _row_cls = _PagedRow
    METRIC_KEYS = SlotEngine.METRIC_KEYS + (
        "kv_pages_free", "prefix_cache_hit_rate",
        "prefill_chunk_backlog", "migrations_in", "migrations_out",
    )

    def __init__(
        self,
        prefill_chunk_fn: Callable,
        decode_fn: Callable,
        slots: int,
        max_len: int,
        prompt_len: int,
        *,
        page_tokens: int,
        pages: int,
        chunk_tokens: int,
        prefix_cache: bool = True,
        role: str = "unified",
        read_page: Optional[Callable] = None,
        write_page: Optional[Callable] = None,
        handoff: Optional[Callable] = None,
    **kw,
    ):
        from dcos_commons_tpu_torch.serve.paging import (
            PageAllocator,
            pages_for,
        )

        # subclass state FIRST: the base constructor starts the loop
        # thread as its last act, and the loop reads these
        self._page_tokens = int(page_tokens)
        self._pages_per_row = pages_for(int(max_len), int(page_tokens))
        self._chunk_tokens = int(chunk_tokens)
        self._allocator = PageAllocator(
            int(pages), int(page_tokens), prefix_cache
        )
        self._prefilling: deque = deque()
        # migration state (serve/migration.py).  role is
        # the pod's advertised serving posture (unified / prefill /
        # decode) — telemetry and routing read it; the HANDOFF hook's
        # presence is what actually diverts finished prefills.
        # read_page/write_page are the device half of page mobility
        # (PagedPoolModel.export_page/import_page on real pods); both
        # run ONLY on the engine loop thread (_device_io), preserving
        # the single-device-caller discipline.
        self._role = str(role)
        self._read_page = read_page
        self._write_page = write_page
        self._handoff = handoff
        self._page_io: deque = deque()
        self._spliced: dict = {}    # rid -> parked row (pre-cutover)
        self._migrated: dict = {}   # rid -> spliced row (collectable)
        self._migrated_in = 0
        self._migrated_out = 0
        super().__init__(
            prefill_chunk_fn, decode_fn, slots, max_len, prompt_len,
            **kw,
        )

    # -- admission ---------------------------------------------------

    def _has_work_locked(self) -> bool:
        return (
            super()._has_work_locked()
            or bool(self._prefilling)
            or bool(self._page_io)
        )

    def _pop_admits_locked(self) -> List[_Row]:
        """FIFO admission under BOTH constraints — a free decode row
        and the page budget.  Strictly in order: the first request
        that does not fit blocks the queue (admitting a smaller later
        one would starve large requests forever)."""
        admits: List[_Row] = []
        while self._queue and self._free:
            row = self._queue[0]
            if row.group.abandoned:
                self._queue.popleft()
                continue
            admission = self._allocator.admit(row.tokens, row.n)
            if admission is None:
                break
            self._queue.popleft()
            row.slot = self._free.pop()
            row.admission = admission
            row.table = np.zeros(self._pages_per_row, np.int32)
            for i, entry in enumerate(admission.matched):
                row.table[i] = entry.page
            # prefill resumes past the cache-served pages
            row.fill_pos = len(admission.matched) * self._page_tokens
            row.registered_to = len(admission.matched)
            admits.append(row)
        return admits

    def _work_tick(self, admits: List[_Row]) -> None:
        """Page jobs, a chunk of every prefilling row, then one decode
        step over the pool: the last two in the profiler ranges
        ``engine.prefill`` and ``engine.decode``."""
        self._run_page_io()
        if admits:
            with self._cv:
                self._prefilling.extend(admits)
        with profiled("engine.prefill"):
            self._prefill_tick()
        if self._active:
            with profiled("engine.decode"):
                self._decode_tick()

    def _run_page_io(self) -> None:
        """Drain queued migration page reads/writes (loop thread,
        outside the cv — these are device calls like any dispatch)."""
        while True:
            with self._cv:
                if not self._page_io:
                    return
                job = self._page_io.popleft()
            job()

    # -- chunked prefill ---------------------------------------------

    def _prefill_tick(self) -> None:
        """Advance EVERY prefilling row by one chunk, FIFO order.

        Per-ROW chunking is the head-of-line fix: a long prompt costs
        several small dispatches interleaved with decode ticks instead
        of one prompt-wide dispatch that blocks the pool — while a
        BURST of short prompts still admits in one tick (each is one
        cheap chunk; serializing them across decode ticks would tax
        every short request one full decode per queue position).
        Per-tick prefill work stays bounded by the slot count — the
        same bound the slot pool's admit-all batch had, at chunk
        width instead of full prompt width."""
        with self._cv:
            rows = list(self._prefilling)
        for row in rows:
            with self._cv:
                if row.admission is None:
                    continue  # already retired/failed this tick
                if row.frozen:
                    continue  # fenced mid-prefill for migration
                if row.group.abandoned:
                    # abandoned before its first token: free the
                    # pages/slot now, nothing ever reached the client
                    self._prefilling.remove(row)
                    self._retire_locked(row)
                    continue
                plen = len(row.tokens)
                start = row.fill_pos
                clen = min(self._chunk_tokens, plen - start)
                self._ensure_pages_locked(row, start, start + clen - 1)
                table = row.table.copy()
            padded = np.zeros((1, self._chunk_tokens), np.int32)
            padded[0, :clen] = row.tokens[start:start + clen]
            first = self._prefill_fn(
                padded, slot=row.slot, table=table, start=start,
                true_len=clen, temp=row.temp, seed=row.seed,
            )
            now = time.monotonic()
            handoff_row = None
            with self._cv:
                row.fill_pos = start + clen
                self._register_pages_locked(row)
                if row.fill_pos >= plen:
                    if row.group.abandoned:
                        self._prefilling.remove(row)
                        self._retire_locked(row)
                    elif self._handoff is not None:
                        # disaggregation: the prompt is prefilled and
                        # its first token sampled — this pod's work
                        # is done.  Count admission/TTFT HERE (the
                        # destination replays neither), fence the row
                        # and ship it to a decode pod outside the cv
                        self._admitted += 1
                        self._ttft.append(now - row.arrival)
                        row.out.append(int(first))
                        self._count_tokens_locked(1, now)
                        if self._row_finished(row, int(first), plen):
                            self._prefilling.remove(row)
                            self._retire_locked(row)
                        else:
                            row.frozen = True
                            handoff_row = row
                    else:
                        self._prefilling.remove(row)
                        self._apply_admit_locked(row, int(first), now)
            if handoff_row is not None:
                self._run_handoff(handoff_row)

    def _run_handoff(self, row) -> None:
        """Hand a finished prefill to the decode pool (loop thread,
        outside the cv).  Any pre-cutover failure falls back to
        decoding locally — a prefill pod degrades to unified rather
        than failing the request.  A post-cutover failure
        (ReleasePendingError) leaves the row frozen: the destination
        owns the session now, and resuming here would double-serve."""
        from dcos_commons_tpu_torch.serve.migration import (
            ReleasePendingError,
        )

        try:
            ok = self._handoff(self, row.rid)
        except ReleasePendingError:
            if self._log is not None:
                self._log(
                    f"handoff of session {row.rid} cut over but "
                    "release failed; holding the frozen source row "
                    "for a retried release"
                )
            return
        except Exception as e:  # noqa: BLE001 — degrade, don't fail the request
            ok = None
            if self._log is not None:
                self._log(
                    f"prefill handoff failed ({e}); decoding locally"
                )
        if ok is None:
            with self._cv:
                if row.frozen:
                    self._unfreeze_locked(row)

    def _ensure_pages_locked(self, row, first_pos: int,
                             last_pos: int) -> None:
        """Allocate the pages covering positions [first_pos,
        last_pos] — drawn from the row's admission reservation, so
        this cannot fail for an admitted row."""
        for v in range(first_pos // self._page_tokens,
                       last_pos // self._page_tokens + 1):
            if row.table[v] == 0:
                page = self._allocator.alloc(row.admission)
                row.table[v] = page
                row.private_pages.append(page)

    def _register_pages_locked(self, row) -> None:
        """Publish every newly-completed FULL prompt page into the
        prefix cache.  The last (partial) prompt page stays private —
        decode keeps writing into it, and shared pages are read-only
        by contract."""
        p = self._page_tokens
        while ((row.registered_to + 1) * p <= row.fill_pos
               and (row.registered_to + 1) * p <= len(row.tokens)):
            v = row.registered_to
            page = int(row.table[v])
            toks = tuple(row.tokens[v * p:(v + 1) * p])
            if self._allocator.register(row.admission, toks, page):
                row.private_pages.remove(page)
            row.registered_to += 1

    # -- decode ------------------------------------------------------

    _MERGE_NOUN = "paged arena"

    def _decode_prep_locked(self) -> tuple:
        """Allocate this tick's write pages and snapshot every row's
        page table for the decode dispatch."""
        for slot, row in enumerate(self._rows):
            if row is None or row.group.abandoned or row.frozen:
                # an abandoned row retires at apply; its write this
                # tick lands in the trash page (table may miss the
                # next page — masked, discarded).  A FROZEN row gets
                # a zero table below: its pages must stop changing
                # the moment the migration fence drops
                continue
            pos = int(self._pos[slot])
            self._ensure_pages_locked(row, pos, pos)
        tables = np.zeros(
            (self._slots, self._pages_per_row), np.int32
        )
        for slot, row in enumerate(self._rows):
            if row is not None and not row.frozen:
                tables[slot] = row.table
        return (tables,)

    # -- migration (serve/migration.py) --------------------

    def _device_io(self, fn):
        """Run a page read/write on the loop thread (the engine's one
        device caller) and return its result.  Called FROM the loop
        thread (prefill handoff) it runs inline; from a migration
        thread it queues and blocks until the loop executes it."""
        from dcos_commons_tpu_torch.serve.migration import MigrationError

        if threading.current_thread() is self._thread:
            return fn()
        done = threading.Event()
        box: dict = {}

        def job():
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in the waiter
                box["error"] = e
            finally:
                done.set()

        with self._cv:
            if self._stopped:
                raise MigrationError("engine stopped")
            self._page_io.append(job)
            self._cv.notify_all()
        if not done.wait(timeout=60.0):
            raise MigrationError("page io stalled on the engine loop")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _find_rid_locked(self, rid: int):
        for row in self._rows:
            if row is not None and row.rid == rid:
                return row
        for row in self._prefilling:
            if row.rid == rid:
                return row
        return None

    def sessions(self) -> List[dict]:
        """Live migratable sessions: rows holding pages that are not
        already fenced — the drain/rebalance work list."""
        out: List[dict] = []
        with self._cv:
            for row in self._prefilling:
                if not row.frozen and not row.group.abandoned:
                    out.append({
                        "rid": row.rid, "tokens": list(row.tokens),
                        "state": "prefill",
                        "pages": int(np.count_nonzero(row.table)),
                    })
            for row in self._rows:
                if (row is not None and not row.frozen
                        and not row.group.abandoned
                        and row.admission is not None):
                    out.append({
                        "rid": row.rid, "tokens": list(row.tokens),
                        "state": "decode",
                        "pages": int(np.count_nonzero(row.table)),
                    })
        return out

    def freeze(self, rid: int) -> None:
        """Fence a session: decode/prefill stop at the next tick
        boundary and its pages stop changing (the in-flight tick's
        write is idempotent — K/V at a position is a pure function of
        token and position — and its sampled token is discarded)."""
        from dcos_commons_tpu_torch.serve.migration import MigrationError

        with self._cv:
            row = self._find_rid_locked(rid)
            if row is None or row.admission is None:
                raise MigrationError(f"no live session {rid} to freeze")
            row.frozen = True

    def unfreeze(self, rid: int) -> None:
        """Drop the fence: an aborted migration resumes exactly where
        it froze.  Silently a no-op when the session is gone (a
        failure fan-out already answered its client)."""
        with self._cv:
            row = self._find_rid_locked(rid)
            if row is None:
                return
            if row.frozen:
                self._unfreeze_locked(row)
            self._cv.notify_all()

    def _unfreeze_locked(self, row) -> None:
        row.frozen = False
        if row in self._prefilling and row.fill_pos >= len(row.tokens):
            # a prefill-COMPLETE fenced row (handoff path): it never
            # entered the decode set, so resuming means installing it
            self._prefilling.remove(row)
            if self._row_finished(
                row, row.out[-1], len(row.tokens) + len(row.out) - 1
            ):
                self._retire_locked(row)
            else:
                self._install_decode_locked(row)
        self._cv.notify_all()

    def export_frozen(self, rid: int):
        """Snapshot a frozen session for the wire: request + progress
        + every mapped page's payload, keyed by VIRTUAL index
        (physical ids never leave the pod).  Page reads run on the
        loop thread."""
        from dcos_commons_tpu_torch.serve.migration import (
            MigrationError,
            SessionSnapshot,
        )

        if self._read_page is None:
            raise MigrationError(
                "no page reader bound (PagedEngine read_page=...)"
            )
        with self._cv:
            row = self._find_rid_locked(rid)
            if row is None or row.admission is None:
                raise MigrationError(f"no live session {rid} to export")
            if not row.frozen:
                raise MigrationError(
                    f"session {rid} is not frozen — export without a "
                    "fence would race decode"
                )
            plen = len(row.tokens)
            kv_end = (
                plen + len(row.out) - 1
                if row.fill_pos >= plen and row.out else row.fill_pos
            )
            pages = [
                (v, int(row.table[v]))
                for v in range(len(row.table)) if row.table[v] != 0
            ]
            meta = (
                list(row.tokens), row.n, row.temp, row.eos, row.seed,
                list(row.out), row.fill_pos,
            )
        payloads = self._device_io(
            lambda: [(v, self._read_page(p)) for v, p in pages]
        )
        tokens, n, temp, eos, seed, out, fill_pos = meta
        return SessionSnapshot(
            rid=rid, tokens=tokens, max_new=n, temperature=temp,
            eos=eos, seed=seed, out=out, fill_pos=fill_pos,
            kv_end=kv_end, page_tokens=self._page_tokens,
            pages=payloads, source=self._role,
        )

    def splice(self, snap) -> int:
        """Admit a migrated session under the SAME transactional rule
        a fresh request faces (paging.admit — worst-case reservation,
        prefix-cache matching), copy only the pages the local prefix
        cache cannot serve, and PARK the row.  Nothing decodes until
        ``activate``; ``abort_splice`` undoes everything.  Returns
        the destination-local rid."""
        from dcos_commons_tpu_torch.serve.migration import MigrationError
        from dcos_commons_tpu_torch.serve.paging import pages_for

        if self._write_page is None:
            raise MigrationError(
                "no page writer bound (PagedEngine write_page=...)"
            )
        if int(snap.page_tokens) != self._page_tokens:
            raise MigrationError(
                f"page geometry mismatch: snapshot has "
                f"{snap.page_tokens}-token pages, this arena "
                f"{self._page_tokens}"
            )
        plen = len(snap.tokens)
        if plen > self._prompt_len or plen + snap.max_new > self._max_len:
            raise MigrationError(
                f"session does not fit this pod's geometry "
                f"({plen}+{snap.max_new} vs {self._max_len})"
            )
        incoming = dict(snap.pages)
        with self._cv:
            if not self._free:
                raise MigrationError("no free decode row")
            admission = self._allocator.admit(snap.tokens, snap.max_new)
            if admission is None:
                raise MigrationError(
                    "page budget cannot admit the migrated session"
                )
            m = len(admission.matched)
            need = (
                pages_for(int(snap.kv_end), self._page_tokens)
                if snap.kv_end > 0 else 0
            )
            missing = [
                v for v in range(m, need) if v not in incoming
            ]
            if missing:
                self._allocator.retire(admission, [])
                raise MigrationError(
                    f"snapshot is missing pages {missing}"
                )
            group = _Group([])
            row = self._row_cls(
                list(snap.tokens), snap.max_new, snap.temperature,
                snap.eos, snap.seed, group,
            )
            group.rows = [row]
            group.remaining = 1
            row.rid = self._next_rid
            self._next_rid += 1
            row.slot = self._free.pop()
            row.admission = admission
            row.table = np.zeros(self._pages_per_row, np.int32)
            for i, entry in enumerate(admission.matched):
                row.table[i] = entry.page
            row.registered_to = m
            # the local cache may hold MORE of the prompt than the
            # source had prefilled — prefill resumes past it
            row.fill_pos = max(int(snap.fill_pos),
                               m * self._page_tokens)
            row.out = [int(t) for t in snap.out]
            row.frozen = True
            imports = []
            for v in range(m, need):
                page = self._allocator.alloc(admission)
                row.table[v] = page
                row.private_pages.append(page)
                imports.append((page, incoming[v]))
            self._spliced[row.rid] = row
            self._migrated[row.rid] = row
            if len(self._migrated) > 256:
                # uncollected finished sessions age out (a router
                # always collects; this bounds a buggy caller)
                for old_rid in [
                    r for r, rw in self._migrated.items()
                    if rw.group.done.is_set()
                ][:64]:
                    self._migrated.pop(old_rid, None)
            self._cv.notify_all()
        try:
            self._device_io(lambda: [
                self._write_page(p, payload) for p, payload in imports
            ])
        except BaseException:
            self.abort_splice(row.rid)
            raise
        return row.rid

    def activate(self, rid: int) -> None:
        """CUTOVER: the parked spliced row starts serving here.  Full
        prompt pages it carried are published to the prefix cache
        only now — after their payloads landed (registering sooner
        would let a concurrent admission pin an unwritten page)."""
        from dcos_commons_tpu_torch.serve.migration import MigrationError

        with self._cv:
            row = self._spliced.pop(rid, None)
            if row is None:
                raise MigrationError(f"no spliced session {rid}")
            row.frozen = False
            self._register_pages_locked(row)
            self._migrated_in += 1
            plen = len(row.tokens)
            if row.fill_pos < plen:
                self._prefilling.append(row)  # resumes chunked prefill
            elif row.out and self._row_finished(
                row, row.out[-1], plen + len(row.out) - 1
            ):
                self._retire_locked(row)
            elif row.out:
                self._install_decode_locked(row)
            else:
                raise MigrationError(
                    f"spliced session {rid} has no resume point"
                )
            if not self._has_work_locked():
                self._last_tick_mono = time.monotonic()
            self._cv.notify_all()

    def abort_splice(self, rid: int) -> None:
        """Undo a splice that never activated: pages and slot return
        to the arena.  No-op when the rid is unknown (already
        activated or never spliced) — abort is best-effort."""
        with self._cv:
            row = self._spliced.pop(rid, None)
            if row is None:
                return
            self._migrated.pop(rid, None)
            self._free.append(row.slot)
            if row.admission is not None:
                self._allocator.retire(row.admission, row.private_pages)
                row.admission = None
                row.private_pages = []
                row.table = None

    def release_migrated(self, rid: int, *, moved_to: str,
                         dest_rid: int) -> None:
        """The protocol's last verb: after cutover, retire the frozen
        source row, free its pages, and answer its blocked client
        with ``SessionMigratedError`` naming the destination (the
        router follows with a collect request)."""
        from dcos_commons_tpu_torch.serve.migration import (
            MigrationError,
            SessionMigratedError,
        )

        with self._cv:
            row = self._find_rid_locked(rid)
            if row is None:
                raise MigrationError(f"no session {rid} to release")
            if not row.frozen:
                raise MigrationError(
                    f"session {rid} is not frozen — release without a "
                    "fence would double-serve"
                )
            if row in self._prefilling:
                self._prefilling.remove(row)
            self._migrated_out += 1
            row.group.error = SessionMigratedError(
                rid, moved_to, dest_rid
            )
            self._retire_locked(row)

    def collect(self, rid: int,
                timeout: Optional[float] = None) -> List[int]:
        """Block until a migrated-in session finishes and return its
        FULL output — the tokens the source already produced plus
        everything decoded here, one seamless reply."""
        from dcos_commons_tpu_torch.serve.migration import MigrationError

        with self._cv:
            row = self._migrated.get(rid)
        if row is None:
            raise MigrationError(
                f"no migrated session {rid} to collect"
            )
        wait_s = timeout if timeout is not None else self._queue_timeout_s
        if not row.group.done.wait(timeout=wait_s):
            raise QueueTimeoutError(
                "migrated session did not finish", kind="stalled"
            )
        with self._cv:
            self._migrated.pop(rid, None)
        if row.group.error is not None:
            raise row.group.error
        return list(row.out)

    # -- retirement / failure ----------------------------------------

    def _retire_locked(self, row) -> None:
        super()._retire_locked(row)
        if row.admission is not None:
            self._allocator.retire(row.admission, row.private_pages)
            row.admission = None
            row.private_pages = []
            row.table = None

    def _fail_all_locked(self, error, extra_groups=()) -> None:
        extra = set(extra_groups)
        extra |= {r.group for r in self._prefilling}
        for row in self._prefilling:
            self._free.append(row.slot)
            row.slot = -1
        self._prefilling.clear()
        # parked spliced rows die with everything else: their groups
        # error out so a blocked collect() unblocks, and their slots
        # return (allocator.reset() below reclaims the pages)
        extra |= {r.group for r in self._spliced.values()}
        for row in self._spliced.values():
            self._free.append(row.slot)
            row.slot = -1
            row.admission = None
        self._spliced.clear()
        super()._fail_all_locked(error, extra_groups=extra)
        # every admission died with its group: rebuild the arena
        # bookkeeping (the prefix cache's pages may hold K/V written
        # before the failure — integrity unknown, so drop them too)
        self._allocator.reset()

    # -- timeout basis / telemetry -----------------------------------

    def _progress_locked(self, group) -> int:
        # chunk progress counts: a long prompt mid-prefill must not
        # be cut off as "stalled" just because no token landed yet
        return super()._progress_locked(group) + sum(
            r.fill_pos for r in group.rows
        )

    def _timeout_reason_locked(self, group, admitted: bool):
        if not admitted:
            alloc = self._allocator
            budget_reason = (
                "request timed out waiting for the KV page budget "
                f"({alloc.free_pages} pages free of "
                f"{alloc.pages_total}, {alloc.reserved_pages} "
                "reserved)",
                "kv-page-budget",
            )
            own = next(
                (r for r in group.rows if r.slot < 0), group.rows[0]
            )
            if not alloc.would_admit(own.tokens, own.n):
                return budget_reason
            if not self._free:
                return (
                    "request timed out waiting for a KV slot",
                    "kv-slot",
                )
            # our own rows fit and decode rows are free, so the
            # starvation came from strict FIFO behind a blocked HEAD
            # (our rows left the queue before this ran): classify by
            # what blocks the head — a small request stuck behind a
            # big budget-blocked one is memory saturation too
            head = self._queue[0] if self._queue else None
            if head is not None and not alloc.would_admit(
                    head.tokens, head.n):
                return budget_reason
            return (
                "request timed out waiting for a KV slot", "kv-slot"
            )
        return super()._timeout_reason_locked(group, admitted)

    def _live_tokens_locked(self) -> int:
        return super()._live_tokens_locked() + sum(
            r.fill_pos for r in self._prefilling
        )

    def _kv_capacity(self) -> int:
        return self._allocator.pages_total * self._page_tokens

    def _stats_extra_locked(self) -> dict:
        out = self._allocator.stats()
        # PHYSICAL occupancy (overrides the base virtual-positions
        # gauge): shared prefix pages count once, not once per
        # pinning row — under heavy sharing the virtual sum can
        # exceed the arena and would falsely breach kv_occupancy_slo
        # while headroom exists.  Occupied = pages neither free nor
        # reclaimable-by-admission.
        alloc = self._allocator
        out["kv_occupancy"] = round(
            (alloc.pages_total - alloc.free_pages
             - alloc.reclaimable_pages) / float(alloc.pages_total),
            4,
        )
        out["kv_page_tokens"] = self._page_tokens
        out["prefill_chunk_tokens"] = self._chunk_tokens
        # prompt tokens not yet prefilled (queued + mid-chunk): the
        # chunked-prefill pressure signal — sustained growth means
        # prefill demand outruns the chunk-per-tick budget
        out["prefill_chunk_backlog"] = int(
            sum(len(r.tokens) - r.fill_pos for r in self._prefilling)
            + sum(len(r.tokens) for r in self._queue)
        )
        # migration surfaces: the pod's serving posture —
        # the router's role-aware placement and the role-aware health
        # gating (health/detectors.py) key on serving_role — and the
        # protocol's traffic counters for /v1/debug/serving
        out["serving_role"] = self._role
        out["migrations_in"] = self._migrated_in
        out["migrations_out"] = self._migrated_out
        return out


def read_servestats(path: str) -> dict:
    """Parse a worker's servestats.json; {} when absent/corrupt (a
    worker killed mid-replace leaves the previous snapshot or none)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}
