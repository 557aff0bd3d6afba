"""Paged KV memory for the serving engine: page allocator, admission
budget, and the refcounted prefix cache.

The slot pool carved KV memory as SLOTS x MAX_LEN rows: a
10-token reply stranded an entire MAX_LEN row.  This module is the
host-side half of the replacement — KV memory becomes a fixed arena
of ``page_tokens``-sized pages and each request holds a PAGE TABLE
(virtual position ``p`` lives in physical page ``table[p //
page_tokens]``), so a short request holds exactly the pages its
tokens need and the freed remainder admits more concurrent requests
under the SAME HBM budget (vLLM's PagedAttention shape).

Everything here is jax-free bookkeeping driven by the engine's loop
thread; the device half (arena tensors, gather-attention) lives in
``models/decode.py`` + ``serve/pool.py``.  Three pieces:

* **Free-list allocator with admission budgeting** — a request is
  admitted only when its WORST-CASE page need (every token decoded,
  no early EOS) fits ``available - reserved``; the need is then
  RESERVED and consumed lazily as positions cross page boundaries, so
  an admitted request can never hit a mid-generation out-of-pages
  (reservations are the invariant: ``reserved <= available`` always).
  Pages freed by early retirement (EOS) return immediately.

* **Prefix cache** — full prompt pages are published into an
  exact-match chain (key = (parent entry, the page's tokens); no
  hash collisions by construction) as READ-ONLY shared pages.  A new
  request whose prompt starts with a cached chain skips prefilling
  those pages entirely: it pins the entries (refcount) and maps them
  into its own table.  At millions-of-users scale most traffic shares
  system prompts, so this multiplies effective KV capacity.

* **Copy-on-write by recompute** — shared pages are never written.
  Cache hits are FULL-page-granular, and a hit is capped so at least
  one prompt token is always prefilled privately; a request that
  diverges mid-page simply misses that page and prefills its own
  private copy, and generated tokens always land in private pages
  (the first decode write position lies past every shared page by
  construction).  Zero-ref entries stay resident and are evicted
  leaf-first in LRU order only under budget pressure.

``paged_config_from_env`` is the ONE env -> paged-geometry contract,
shared by both serve workers, shardcheck's ``_serve_leaves`` footprint
model, and (through the serve workload profiles) the admission
gate — a page budget that cannot hold even one max-length request is
a deploy-time SpecError, not a permanent runtime 503.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# a serving geometry that cannot serve raises the one spec error, as
# the JAX package's ``paged_config_from_env`` does; the name stays
# exported here
from dcos_commons_tpu_torch.specification.specs import SpecError

# physical page 0 is the TRASH page: never allocated, the scatter
# target for padding/inactive-row writes in the device kernels (a
# page-table entry of 0 also means "virtual page not yet allocated" —
# such positions are always masked out of attention)
TRASH_PAGE = 0


def pages_for(tokens: int, page_tokens: int) -> int:
    """Pages covering ``tokens`` KV positions (ceil)."""
    return (tokens + page_tokens - 1) // page_tokens


def worst_case_pages(prompt_len: int, max_new: int, page_tokens: int) -> int:
    """Worst-case pages one request can ever WRITE: positions
    ``[0, prompt_len + max_new - 1)`` — the final sampled token is
    returned but its K/V is never written (nothing decodes after
    it)."""
    return pages_for(prompt_len + max_new - 1, page_tokens)


@dataclass
class PagedServeConfig:
    """The env -> paged-serving geometry contract (one source for
    workers, shardcheck, and the admission gate)."""

    page_tokens: int       # KV positions per page
    pages: int             # usable pages (trash page NOT included)
    chunk_tokens: int      # prefill chunk width (the compile width)
    max_len: int           # virtual per-request position cap
    slots: int             # max concurrent decode rows
    prefix_cache: bool     # share read-only prompt pages

    @property
    def pages_per_row(self) -> int:
        """Page-table length per request row."""
        return pages_for(self.max_len, self.page_tokens)

    @property
    def arena_pages(self) -> int:
        """Physical arena size: usable pages + the trash page."""
        return self.pages + 1


def paged_config_from_env(env) -> Optional[PagedServeConfig]:
    """Derive the paged-serving geometry from a task env; ``None``
    when ``KV_PAGE_TOKENS=0`` selects the legacy slot pool.  Raises
    ``SpecError`` for a geometry that cannot serve (so admission and
    CI reject the spec and a worker fails deploy loudly)."""
    page_tokens = int(env.get("KV_PAGE_TOKENS") or "16")
    if page_tokens <= 0:
        return None
    max_len = int(env.get("MAX_LEN", "256"))
    # unset SERVE_BATCH means a bare/dev launch; fall back to one
    # slot rather than the deploy default 8 (see options.json
    # serving.batch description)
    # sdklint: disable=config-default-drift — dev fallback
    batch = int(env.get("SERVE_BATCH", "1"))
    slots = int(env.get("SERVE_SLOTS") or 0) or batch
    # default budget = full residency for every row (NO overcommit:
    # byte-identical to the slot pool it replaces); operators lower
    # KV_PAGES below slots x pages_per_row to overcommit on the mean
    # request, or raise SERVE_SLOTS at fixed KV_PAGES for free
    # concurrency on short traffic
    per_row = pages_for(max_len, page_tokens)
    pages = int(env.get("KV_PAGES") or 0) or slots * per_row
    chunk = int(env.get("PREFILL_CHUNK_TOKENS") or "64")
    if chunk <= 0:
        raise SpecError(
            f"PREFILL_CHUNK_TOKENS must be >= 1, got {chunk}"
        )
    need_one = pages_for(max_len - 1, page_tokens)
    if pages < need_one:
        raise SpecError(
            f"KV page budget overcommitted: {pages} pages x "
            f"{page_tokens} tokens cannot hold one MAX_LEN={max_len} "
            f"request ({need_one} pages worst-case) — raise "
            f"serving.kv_pages or lower MAX_LEN"
        )
    prefix = (env.get("PREFIX_CACHE", "1") or "1") not in ("0", "false")
    return PagedServeConfig(
        page_tokens=page_tokens, pages=pages, chunk_tokens=chunk,
        max_len=max_len, slots=slots, prefix_cache=prefix,
    )


class _PrefixEntry:
    """One cached read-only prompt page in the exact-match chain."""

    __slots__ = ("eid", "key", "page", "refs", "children")

    def __init__(self, eid: int, key: tuple, page: int):
        self.eid = eid
        self.key = key          # (parent_eid, page-token tuple)
        self.page = page
        self.refs = 0           # active requests reading this page
        self.children = 0       # resident entries chained below


class Admission:
    """The allocator's answer to one admitted request: the pinned
    prefix-chain entries plus the reservation the request draws its
    private pages from."""

    __slots__ = ("matched", "reserve_left", "chain_tail", "chain_open")

    def __init__(self, matched: List[_PrefixEntry], need: int):
        self.matched = matched
        self.reserve_left = need     # un-allocated reservation remainder
        # registration chains onto the last matched entry; a register
        # that finds its key already published closes the chain (the
        # canonical entry belongs to another request)
        self.chain_tail: Optional[_PrefixEntry] = (
            matched[-1] if matched else None
        )
        self.chain_open = True

    @property
    def cached_pages(self) -> int:
        return len(self.matched)


class PageAllocator:
    """Free-list page allocator + prefix cache + admission budget.

    Single-threaded by contract: every call happens on the engine's
    loop thread (or under the engine's cv for stats) — the same
    discipline as the engine's other bookkeeping.  All page ids are
    in ``[1, pages]``; 0 is the trash page and is never owned.

    Core invariant (the budget soundness the property tests hold):
    ``reserved <= available()`` at every step, where ``available`` is
    free pages plus evictable zero-ref cache leaves — so an alloc
    drawn from a reservation can NEVER fail mid-generation.
    """

    def __init__(self, pages: int, page_tokens: int,
                 prefix_cache: bool = True):
        if pages < 1:
            raise ValueError(f"page arena needs >= 1 page, got {pages}")
        if page_tokens < 1:
            raise ValueError(
                f"pages need >= 1 token, got {page_tokens}"
            )
        self.pages_total = pages
        self.page_tokens = page_tokens
        self._prefix_enabled = prefix_cache
        self._free: List[int] = list(range(pages, 0, -1))  # pop -> 1
        self._free_set = set(self._free)
        self._reserved = 0
        self._entries: Dict[tuple, _PrefixEntry] = {}
        self._by_id: Dict[int, _PrefixEntry] = {}
        self._cache_pages = set()  # pages owned by cache entries
        self._lru: "OrderedDict[int, _PrefixEntry]" = OrderedDict()
        # zero-ref entries: ALL reclaimable.  Matching pins whole
        # prefix chains (root-first) and retire unpins them whole, so
        # refcounts are monotone down a chain — a zero-ref entry's
        # entire subtree is zero-ref and leaf-first eviction reaches
        # it transitively.  The LRU holds only the current leaves;
        # this counter is the admission-budget view
        self._zero_refs = 0
        self._next_eid = 1
        # telemetry
        self.prefix_lookups = 0    # prompt pages eligible for a hit
        self.prefix_hits = 0       # prompt pages served from cache
        self.evictions = 0

    def reset(self) -> None:
        """Drop every ownership and cache entry (the engine's
        fail-all path: all admissions died with their groups and the
        arena's contents are no longer trustworthy).  Telemetry
        counters survive — a reset is not a statistics amnesty."""
        self._free = list(range(self.pages_total, 0, -1))
        self._free_set = set(self._free)
        self._reserved = 0
        self._entries.clear()
        self._by_id.clear()
        self._cache_pages.clear()
        self._lru.clear()
        self._zero_refs = 0

    # -- budget ------------------------------------------------------

    def available(self) -> int:
        """Pages an admission may draw on: free + zero-ref cache
        entries (all transitively evictable, leaf-first — see
        ``_zero_refs``)."""
        return len(self._free) + self._zero_refs

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        """Resident prefix-cache pages (pinned + reclaimable)."""
        return len(self._by_id)

    @property
    def reclaimable_pages(self) -> int:
        return self._zero_refs

    @property
    def reserved_pages(self) -> int:
        return self._reserved

    def _match_and_need(self, prompt: Sequence[int], max_new: int):
        """The ONE admission formula (shared by ``admit`` and
        ``would_admit`` so the budget decision and the 503 timeout
        classification can never drift): match the prefix chain and
        compute (matched entries, lookup cap, worst-case private-page
        need, budget charge incl. pins of zero-ref entries).  The hit
        is capped so >= 1 prompt token is always prefilled privately:
        the model output at the LAST prompt position is what samples
        the first token — a fully-cached prompt still needs that
        forward pass."""
        plen = len(prompt)
        p = self.page_tokens
        limit = (plen - 1) // p
        matched: List[_PrefixEntry] = []
        if self._prefix_enabled and limit > 0:
            parent_eid = 0
            for i in range(limit):
                key = (parent_eid, tuple(prompt[i * p:(i + 1) * p]))
                entry = self._entries.get(key)
                if entry is None:
                    break
                matched.append(entry)
                parent_eid = entry.eid
        need = worst_case_pages(plen, max_new, p) - len(matched)
        # pinning a zero-ref entry removes it from ``available``, so
        # the admission check must charge for those pins too
        charge = need + sum(1 for e in matched if e.refs == 0)
        return matched, limit, need, charge

    def admit(
        self, prompt: Sequence[int], max_new: int,
    ) -> Optional[Admission]:
        """Transactional admission: match the prefix cache, compute
        the worst-case private-page need, and admit only if it fits.

        Returns ``None`` (leave the request queued, nothing mutated)
        when the budget cannot cover it.  On success the matched
        entries are PINNED and the need RESERVED (an admission must
        never push ``reserved`` past ``available``)."""
        matched, limit, need, charge = self._match_and_need(
            prompt, max_new
        )
        if charge + self._reserved > self.available():
            return None
        # count the hit telemetry only for ADMITTED requests ("nothing
        # mutated" on the None return): a budget-blocked head is
        # re-attempted every engine tick, and counting those retries
        # would drown prefix_cache_hit_rate in retry noise exactly
        # when the arena is saturated
        if self._prefix_enabled and limit > 0:
            self.prefix_lookups += limit
            self.prefix_hits += len(matched)
        for entry in matched:
            self._pin(entry)
        self._reserved += need
        return Admission(matched, need)

    def would_admit(self, prompt: Sequence[int], max_new: int) -> bool:
        """The admission check WITHOUT side effects (the submit-path
        timeout uses it to name the blocking resource)."""
        _, _, _, charge = self._match_and_need(prompt, max_new)
        return charge + self._reserved <= self.available()

    # -- page movement -----------------------------------------------

    def alloc(self, admission: Admission) -> int:
        """Hand one page to an admitted request, drawn from its
        reservation (evicting a zero-ref cache leaf if the free list
        is dry).  A reservation underflow or an empty arena here is an
        ENGINE bug — the admission check exists to make it
        impossible — so it raises instead of limping."""
        if admission.reserve_left <= 0:
            raise RuntimeError(
                "page alloc past the admission's worst-case reservation"
            )
        if not self._free:
            self._evict_one()
        page = self._free.pop()
        self._free_set.discard(page)
        admission.reserve_left -= 1
        self._reserved -= 1
        return page

    def free_page(self, page: int) -> None:
        """Return a PRIVATE page (double-free and trash/cache-page
        frees raise: each is a table-corruption bug upstream)."""
        if page == TRASH_PAGE or not 1 <= page <= self.pages_total:
            raise RuntimeError(f"freeing invalid page {page}")
        if page in self._free_set:
            raise RuntimeError(f"double free of page {page}")
        if page in self._cache_pages:
            raise RuntimeError(
                f"freeing page {page} owned by the prefix cache"
            )
        self._free.append(page)
        self._free_set.add(page)

    def retire(self, admission: Admission,
               private_pages: Sequence[int]) -> None:
        """Release everything one request held: the un-consumed
        reservation, its private pages, and its pins (matched AND
        self-registered entries — a registered page must stay pinned
        while its registrant can still gather from it)."""
        self._reserved -= admission.reserve_left
        admission.reserve_left = 0
        for page in private_pages:
            self.free_page(page)
        for entry in admission.matched:
            self._unpin(entry)

    # -- prefix cache ------------------------------------------------

    def register(
        self, admission: Admission, page_tokens: Tuple[int, ...],
        page: int,
    ) -> bool:
        """Publish one fully-prefilled PRIVATE prompt page into the
        cache, chained onto the request's current tail.  Ownership of
        ``page`` transfers to the cache; the registrant keeps a pin
        until retire (``admission.matched`` grows the new entry).

        Returns False (page stays private) when the chain is closed
        or the key already exists — a concurrent identical prompt
        published first; this request keeps its duplicate private and
        the canonical entry serves future hits.  Once closed, the
        chain stays closed: deeper pages cannot chain onto another
        request's entry without pinning machinery admission never
        budgeted for."""
        if not self._prefix_enabled or not admission.chain_open:
            return False
        if len(page_tokens) != self.page_tokens:
            raise RuntimeError(
                f"registering a partial page ({len(page_tokens)} of "
                f"{self.page_tokens} tokens)"
            )
        parent = admission.chain_tail
        key = ((parent.eid if parent else 0), tuple(page_tokens))
        if key in self._entries:
            admission.chain_open = False
            return False
        entry = _PrefixEntry(self._next_eid, key, page)
        self._next_eid += 1
        entry.refs = 1  # the registrant's pin, released at retire
        if parent is not None:
            # parent is pinned by this request (matched or registered
            # earlier in this chain): refs >= 1, so it cannot be in
            # the LRU and gaining a child never shrinks ``available``
            parent.children += 1
        self._entries[key] = entry
        self._by_id[entry.eid] = entry
        self._cache_pages.add(page)
        admission.matched.append(entry)
        admission.chain_tail = entry
        return True

    def _pin(self, entry: _PrefixEntry) -> None:
        if entry.refs == 0:
            self._zero_refs -= 1
        entry.refs += 1
        self._lru.pop(entry.eid, None)

    def _unpin(self, entry: _PrefixEntry) -> None:
        entry.refs -= 1
        if entry.refs < 0:
            raise RuntimeError(f"refcount underflow on entry {entry.eid}")
        if entry.refs == 0:
            self._zero_refs += 1
            if entry.children == 0:
                self._lru[entry.eid] = entry
                self._lru.move_to_end(entry.eid)

    def _evict_one(self) -> None:
        if not self._lru:
            raise RuntimeError(
                "page arena empty with nothing evictable (budget "
                "invariant violated)"
            )
        _eid, entry = self._lru.popitem(last=False)  # oldest leaf
        del self._entries[entry.key]
        del self._by_id[entry.eid]
        self._cache_pages.discard(entry.page)
        self._zero_refs -= 1  # lru membership implies refs == 0
        parent_eid = entry.key[0]
        if parent_eid:
            parent = self._by_id.get(parent_eid)
            if parent is not None:
                parent.children -= 1
                if parent.refs == 0 and parent.children == 0:
                    self._lru[parent.eid] = parent
        self._free.append(entry.page)
        self._free_set.add(entry.page)
        self.evictions += 1

    # -- introspection (tests + stats) -------------------------------

    def check_invariants(self, private_pages: Sequence[int] = ()) -> None:
        """Conservation + budget soundness; the property tests call
        this after every op.  ``private_pages``: every page currently
        owned by live requests (the engine's tables)."""
        cached = {e.page for e in self._by_id.values()}
        private = list(private_pages)
        if len(cached) != len(self._by_id):
            raise AssertionError("two cache entries share a page")
        if len(set(private)) != len(private):
            raise AssertionError("two requests own the same page")
        if set(private) & cached:
            raise AssertionError("a private page is also cache-owned")
        if set(private) & self._free_set or cached & self._free_set:
            raise AssertionError("an owned page is on the free list")
        total = len(self._free) + len(cached) + len(private)
        if total != self.pages_total:
            raise AssertionError(
                f"page conservation broken: {len(self._free)} free + "
                f"{len(cached)} cached + {len(private)} private != "
                f"{self.pages_total}"
            )
        if self._reserved < 0:
            raise AssertionError("negative reservation")
        if self._reserved > self.available():
            raise AssertionError(
                f"reserved {self._reserved} > available "
                f"{self.available()}: an admitted request can OOM"
            )
        zero = 0
        for entry in self._by_id.values():
            zero += entry.refs == 0
            evictable = entry.refs == 0 and entry.children == 0
            if evictable != (entry.eid in self._lru):
                raise AssertionError(
                    f"entry {entry.eid} LRU membership inconsistent "
                    f"(refs={entry.refs}, children={entry.children})"
                )
            parent_eid = entry.key[0]
            if parent_eid and entry.refs > 0:
                parent = self._by_id.get(parent_eid)
                if parent is None or parent.refs <= 0:
                    raise AssertionError(
                        f"pinned entry {entry.eid} has an unpinned/"
                        "evicted parent (chain-pin monotonicity broken)"
                    )
        if zero != self._zero_refs:
            raise AssertionError(
                f"zero-ref count drifted: {self._zero_refs} tracked, "
                f"{zero} actual"
            )

    def stats(self) -> dict:
        lookups = self.prefix_lookups
        return {
            "kv_pages_total": self.pages_total,
            "kv_pages_free": len(self._free),
            "kv_pages_cached": len(self._by_id),
            # all zero-ref entries, matching the admission view — not
            # just the current LRU leaves (a zero-ref CHAIN is
            # transitively evictable, and the gauge must agree with
            # what available() would actually hand an admission)
            "kv_pages_reclaimable": self._zero_refs,
            "kv_pages_reserved": self._reserved,
            "prefix_cache_hits": self.prefix_hits,
            "prefix_cache_lookups": lookups,
            "prefix_cache_evictions": self.evictions,
            "prefix_cache_hit_rate": round(
                self.prefix_hits / lookups, 4
            ) if lookups else 0.0,
        }
