"""Prefix affinity: route shared-prefix sessions to the pod that
already holds their cached pages.

The paged engine's prefix cache interns fully-prefilled prompt pages under an
exact-match CHAIN key — ``(parent entry, the page's token tuple)``,
page-aligned (serve/paging.py ``register``).  Under fan-out that
cache is per POD: spraying shared-system-prompt traffic round-robin
dilutes every pod's hit rate by 1/N, because each pod re-prefills the
same system prompt from scratch.  The router therefore hashes each
prompt with the SAME chain construction — page-aligned full pages,
each key folded over its parent — and remembers which pod last served
each chain node.  A new request walks its chain deepest-first and
follows the pod holding the longest known prefix; the pods' own
allocators then serve the pages from cache.

The chain key here is structurally identical to the paging intern key
with the allocator-private entry id replaced by the parent's HASH:
two prompts collide exactly when their page-aligned prefixes match,
which is precisely when the pod-side cache would hit.  The map is
bounded LRU — affinity is a HINT, not state: an evicted entry costs
one re-prefill on whatever pod least-loaded picks next, never a
correctness problem.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple


def prefix_chain_keys(
    tokens: Sequence[int], page_tokens: int,
) -> List[int]:
    """The prompt's page-aligned prefix chain, root first: key[i]
    covers full pages ``[0, i]``.  Mirrors ``PageAllocator`` matching:
    only FULL pages participate, and the last page is capped so at
    least one prompt token always prefills privately (a fully-cached
    prompt still needs its final-position forward pass) — so the
    router's deepest key can never claim more than a pod could hit."""
    plen = len(tokens)
    if page_tokens < 1 or plen < 1:
        return []
    limit = (plen - 1) // page_tokens
    keys: List[int] = []
    parent = 0
    for i in range(limit):
        page = tuple(tokens[i * page_tokens:(i + 1) * page_tokens])
        parent = hash((parent, page))
        keys.append(parent)
    return keys


class AffinityMap:
    """Bounded chain-node -> pod map with LRU eviction.

    ``record`` claims a chain for a pod after the router commits a
    request there (deepest nodes recorded too: a later LONGER shared
    prefix extends the claim).  ``lookup`` walks deepest-first and
    returns the first node claimed by a still-offered pod.  ``evict``
    drops every claim on a pod leaving the set (drain/death) — its
    cache died with it, and affinity must not keep steering traffic
    at a corpse."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"affinity map needs capacity >= 1, got "
                             f"{capacity}")
        self._capacity = int(capacity)
        self._claims: "OrderedDict[int, str]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._claims)

    def record(self, keys: Sequence[int], pod: str) -> None:
        for key in keys:
            self._claims[key] = pod
            self._claims.move_to_end(key)
        while len(self._claims) > self._capacity:
            self._claims.popitem(last=False)

    def lookup(self, keys: Sequence[int]) -> Tuple[Optional[str], int]:
        """(pod, matched-depth) for the deepest claimed node; (None,
        0) when no node is claimed.  Touches the hit for LRU."""
        for depth in range(len(keys), 0, -1):
            pod = self._claims.get(keys[depth - 1])
            if pod is not None:
                self._claims.move_to_end(keys[depth - 1])
                return pod, depth
        return None, 0

    def evict_pod(self, pod: str) -> int:
        dead = [k for k, p in self._claims.items() if p == pod]
        for key in dead:
            del self._claims[key]
        return len(dead)

    def repoint(self, keys: Sequence[int], pod: str) -> int:
        """Re-point EXISTING claims on the given chain to ``pod`` —
        the cache-preserving half of migration: when a
        session's pages move, the knowledge of where its prefix lives
        moves with them instead of being dropped.  Only nodes already
        claimed move (an unclaimed node carries no knowledge); returns
        how many moved."""
        moved = 0
        for key in keys:
            if key in self._claims:
                self._claims[key] = pod
                self._claims.move_to_end(key)
                moved += 1
        return moved

    def repoint_pod(self, old: str, new: str) -> int:
        """Bulk re-point: every claim on ``old`` now names ``new`` —
        the drain-with-migration path, where the whole cache moved."""
        moved = 0
        for key, pod in self._claims.items():
            if pod == old:
                self._claims[key] = new
                moved += 1
        return moved

    def claims_by_pod(self) -> dict:
        """Claim counts per pod — the hotspot-detection signal: a pod
        holding far more chain claims than its peers is where the
        shared prefixes (and their traffic) concentrate."""
        counts: dict = {}
        for pod in self._claims.values():
            counts[pod] = counts.get(pod, 0) + 1
        return counts
