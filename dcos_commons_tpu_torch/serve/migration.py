"""Live KV page migration: sessions move between pods mid-generation.

The paged arena made the KV page the unit of serving MEMORY; this module makes
it the unit of serving MOBILITY.  A session's state is small and
closed — its prompt, its sampling parameters, the tokens produced so
far, and the arena pages its page table points at — so a pod can
snapshot it, stream it over the inter-pod (DCN) lane, and a peer can
splice it into its own ``PageAllocator`` under the exact admission
rule a fresh request would face.  Three consumers share the one
protocol:

* **drain** — a scale-in/maintenance drain moves in-flight sessions
  to surviving pods instead of waiting out every generation
  (``drain_sessions``);
* **rebalance** — a prefix-hotspot pod sheds sessions WITH their
  cached pages, so the router's affinity claims re-point instead of
  being dropped (the chain keys ride the drain report);
* **disaggregation** — dedicated prefill pods run chunked prefill
  and hand finished pages to decode pools (``PrefillHandoff``), so
  long prompts never sit inside a decode pod's tick.

The cutover protocol (the plancheck ``migration`` config model-checks
it under abort and pod death at every state):

    source serving
      -> FREEZE    source fences the row at a tick boundary: decode
                   stops, the row's pages stop changing (writes of
                   the in-flight tick are idempotent — K/V at a
                   position is a pure function of token and position)
      -> SNAPSHOT  page payloads read on the source's loop thread
                   (the engine's single-device-caller discipline)
      -> STREAM    the snapshot crosses the transport lane
      -> SPLICE    destination admits the session transactionally
                   (its own prefix cache serves any matched prefix —
                   matched pages are never streamed twice), copies
                   the remaining payloads into freshly drawn pages,
                   and parks the row
      -> CUTOVER   destination activates the parked row; from this
                   state the move is FINAL — abort must refuse
      -> RELEASE   source retires the frozen row, frees its pages,
                   and answers its blocked client with
                   ``SessionMigratedError`` naming the destination

Exactly-once by construction: the source is fenced before anything
streams and only ever resumes via an abort that the destination has
not activated; the destination only decodes after CUTOVER.  Greedy
output is bit-identical across the move because decode resumes from
the same (token, position) against byte-identical pages; SAMPLED
output is too, because the per-row PRNG folds the row's seed with
its POSITION (serve/pool.py) — never the slot or the pod it runs on.

Everything here is transport-agnostic: engines are ducks exposing
the PagedEngine migration verbs, and the wire format
(``SessionSnapshot.to_wire``) is JSON-safe so the HTTP workers can
carry it pod-to-pod (frameworks/jax/serve_worker.py POST /migrate).
"""

from __future__ import annotations

import base64
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class MigrationError(RuntimeError):
    """The move could not proceed (no budget, no free row, geometry
    mismatch, transport failure).  The source session is resumed —
    a failed migration is an abort, never a loss."""


class ReleasePendingError(MigrationError):
    """The move CUT OVER — the destination serves the session — but
    releasing the source failed (a crash at the worst boundary).  The
    source row must stay frozen: resuming it would double-serve, and
    re-streaming would double-splice.  The only legal continuation is
    retrying ``source.release_migrated`` with the fields here."""

    def __init__(self, rid: int, moved_to: str, dest_rid: int):
        super().__init__(
            f"session {rid} cut over to {moved_to} (rid {dest_rid}) "
            "but the source release is pending"
        )
        self.rid = rid
        self.moved_to = moved_to
        self.dest_rid = dest_rid


class SessionMigratedError(RuntimeError):
    """Raised to the SOURCE pod's blocked client after cutover: the
    session now lives on ``moved_to`` as ``dest_rid``.  The router
    follows it with a collect request ({"collect": dest_rid}) and the
    client sees one uninterrupted reply — zero tokens lost, none
    doubled."""

    def __init__(self, rid: int, moved_to: str, dest_rid: int):
        super().__init__(
            f"session {rid} migrated to {moved_to} (rid {dest_rid})"
        )
        self.rid = rid
        self.moved_to = moved_to
        self.dest_rid = dest_rid


# -- the snapshot -----------------------------------------------------


def _payload_bytes(payload) -> int:
    if isinstance(payload, np.ndarray):
        return int(payload.nbytes)
    if isinstance(payload, dict):
        return sum(
            _payload_bytes(k) + _payload_bytes(v)
            for k, v in payload.items()
        )
    if isinstance(payload, (list, tuple)):
        return sum(_payload_bytes(v) for v in payload)
    return 8  # scalar


def _enc(x):
    """JSON-safe encoding for page payloads (numpy arrays, nested
    dicts with non-string keys — both real arena slices and the test
    harnesses' cell dicts)."""
    if isinstance(x, np.ndarray):
        return {
            "__nd__": [
                x.dtype.str, list(x.shape),
                base64.b64encode(np.ascontiguousarray(x).tobytes())
                .decode("ascii"),
            ]
        }
    if isinstance(x, dict):
        return {"__kv__": [[_enc(k), _enc(v)] for k, v in x.items()]}
    if isinstance(x, (list, tuple)):
        return {"__seq__": [_enc(v) for v in x]}
    return x


def _dec(x):
    if isinstance(x, dict):
        if "__nd__" in x:
            dtype, shape, raw = x["__nd__"]
            return np.frombuffer(
                base64.b64decode(raw), dtype=np.dtype(dtype)
            ).reshape(shape).copy()
        if "__kv__" in x:
            return {_dec(k): _dec(v) for k, v in x["__kv__"]}
        if "__seq__" in x:
            return [_dec(v) for v in x["__seq__"]]
    return x


@dataclass
class SessionSnapshot:
    """One frozen session, closed over everything the destination
    needs: the request (prompt + sampling parameters), the progress
    (tokens out, prefill position), and the page payloads keyed by
    VIRTUAL page index — physical page ids are pod-private and never
    cross the wire."""

    rid: int
    tokens: List[int]
    max_new: int
    temperature: float
    eos: Optional[int]
    seed: int
    out: List[int]
    fill_pos: int          # prompt positions prefilled so far
    kv_end: int            # KV positions materialized ([0, kv_end))
    page_tokens: int
    pages: List[Tuple[int, object]] = field(default_factory=list)
    source: str = ""

    def nbytes(self) -> int:
        """Approximate wire size (the transport model's basis)."""
        return (
            8 * (len(self.tokens) + len(self.out) + 8)
            + sum(_payload_bytes(p) for _v, p in self.pages)
        )

    def to_wire(self) -> dict:
        return {
            "rid": self.rid,
            "tokens": list(self.tokens),
            "max_new": self.max_new,
            "temperature": self.temperature,
            "eos": self.eos,
            "seed": self.seed,
            "out": list(self.out),
            "fill_pos": self.fill_pos,
            "kv_end": self.kv_end,
            "page_tokens": self.page_tokens,
            "pages": [[v, _enc(p)] for v, p in self.pages],
            "source": self.source,
        }

    @classmethod
    def from_wire(cls, data: dict) -> "SessionSnapshot":
        return cls(
            rid=int(data["rid"]),
            tokens=[int(t) for t in data["tokens"]],
            max_new=int(data["max_new"]),
            temperature=float(data["temperature"]),
            eos=None if data.get("eos") is None else int(data["eos"]),
            seed=int(data["seed"]),
            out=[int(t) for t in data["out"]],
            fill_pos=int(data["fill_pos"]),
            kv_end=int(data["kv_end"]),
            page_tokens=int(data["page_tokens"]),
            pages=[(int(v), _dec(p)) for v, p in data["pages"]],
            source=str(data.get("source", "")),
        )


# -- transports -------------------------------------------------------


class InProcessTransport:
    """The identity lane (tests, single-process benches): the
    snapshot IS the wire message.  Counts bytes and sessions so every
    consumer reports transfer volume the same way."""

    def __init__(self) -> None:
        self.sessions = 0
        self.bytes_sent = 0

    def send(self, snap: SessionSnapshot) -> SessionSnapshot:
        self.sessions += 1
        self.bytes_sent += snap.nbytes()
        return snap


class SimulatedDcnTransport(InProcessTransport):
    """The in-process lane with a DCN cost model on top: per-session
    latency plus bytes over a bandwidth budget (SURVEY §5.8's
    inter-slice numbers are the defaults' shape — the bench uses this
    so drain-time fences measure protocol cost, not host memcpy)."""

    def __init__(self, gbytes_per_s: float = 12.5,
                 latency_s: float = 0.002) -> None:
        super().__init__()
        self.gbytes_per_s = float(gbytes_per_s)
        self.latency_s = float(latency_s)

    def send(self, snap: SessionSnapshot) -> SessionSnapshot:
        nbytes = snap.nbytes()
        # the modeled wire time IS this transport's contract; it runs
        # on the migration caller's thread, never an engine loop
        time.sleep(  # sdklint: disable=no-blocking-sleep — modeled DCN latency, bench-only lane
            self.latency_s + nbytes / (self.gbytes_per_s * 1e9)
        )
        return super().send(snap)


class HttpEngineClient:
    """A remote PagedEngine's migration verbs over the serve worker's
    ``POST /migrate`` surface (frameworks/jax/serve_worker.py) — the
    destination duck ``migrate_session``/``drain_sessions``/
    ``PrefillHandoff`` drive when the peer lives in another process.
    Every transport or HTTP failure surfaces as ``MigrationError``,
    which the callers already treat as try-the-next-destination; a
    timed-out ``activate`` is the one ambiguous boundary (the peer may
    have activated) — the operations guide's stuck-transfer triage
    covers it."""

    def __init__(self, name: str, address: str,
                 timeout_s: float = 60.0):
        self.name = name
        self.address = address
        self.timeout_s = float(timeout_s)

    def _post(self, body: dict) -> dict:
        import json
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"http://{self.address}/migrate",
            data=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout_s
            ) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            raise MigrationError(
                f"{self.name} refused {body.get('verb')}: "
                f"{e.read().decode('utf-8', 'replace')[:200]}"
            ) from e
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise MigrationError(
                f"{self.name} ({self.address}) unreachable during "
                f"{body.get('verb')}: {e}"
            ) from e

    def splice(self, snap: SessionSnapshot) -> int:
        return int(
            self._post({"verb": "splice",
                        "snapshot": snap.to_wire()})["dest_rid"]
        )

    def activate(self, rid: int) -> None:
        self._post({"verb": "activate", "rid": int(rid)})

    def abort_splice(self, rid: int) -> None:
        self._post({"verb": "abort", "rid": int(rid)})

    def stats(self) -> dict:
        import json
        import urllib.request

        try:
            with urllib.request.urlopen(
                f"http://{self.address}/stats", timeout=self.timeout_s
            ) as resp:
                body = json.loads(resp.read().decode("utf-8"))
            return body if isinstance(body, dict) else {}
        except (OSError, ValueError):
            return {}  # ranked last by the free-pages sort


# -- the protocol -----------------------------------------------------

# boundary names, in protocol order: chaos hooks fire at each (the
# chaos tests kill at every one and assert exactly-once cutover)
STAGES = ("snapshot", "stream", "splice", "cutover", "release")


@dataclass
class MigrationRecord:
    """One completed (or failed) move — the debug-surface row."""

    rid: int
    dest_rid: int
    dest: str
    pages: int
    bytes: int
    duration_s: float
    stage: str          # last stage reached ("release" = complete)
    ok: bool


def migrate_session(
    source,
    dest,
    rid: int,
    *,
    dest_name: str = "",
    transport: Optional[InProcessTransport] = None,
    chaos: Optional[Callable[[str], None]] = None,
    already_frozen: bool = False,
    log: Optional[Callable[[str], None]] = None,
) -> MigrationRecord:
    """Move one session from ``source`` to ``dest`` under the fenced
    cutover protocol.  Any failure BEFORE cutover aborts cleanly: the
    destination's splice (if any) is retired and the source resumes
    decoding exactly where it froze.  A failure AFTER cutover never
    resumes the source (that would double-serve) — the destination
    owns the session and the source row stays frozen for a retried
    release (``release_migrated`` is idempotent per rid).

    ``chaos(stage)`` is the fault-injection hook: it runs at each
    boundary and may raise to simulate a death there.
    """
    transport = transport or InProcessTransport()
    chaos = chaos or (lambda stage: None)
    t0 = time.monotonic()
    stage = "snapshot"
    if not already_frozen:
        source.freeze(rid)
    dest_rid = -1
    try:
        chaos("snapshot")
        snap = source.export_frozen(rid)
        stage = "stream"
        chaos("stream")
        snap = transport.send(snap)
        stage = "splice"
        chaos("splice")
        dest_rid = dest.splice(snap)
    except BaseException:
        # pre-cutover failure: nothing activated, the source resumes
        if dest_rid >= 0:
            dest.abort_splice(dest_rid)
        source.unfreeze(rid)
        raise
    try:
        stage = "cutover"
        chaos("cutover")
        dest.activate(dest_rid)
    except BaseException:
        dest.abort_splice(dest_rid)
        source.unfreeze(rid)
        raise
    # CUTOVER DONE: from here the destination serves.  A failure in
    # release leaves the source frozen (never resumed — resuming now
    # is the double-serve plancheck forbids); release is retryable.
    stage = "release"
    try:
        chaos("release")
        source.release_migrated(
            rid, moved_to=dest_name, dest_rid=dest_rid
        )
    except BaseException as e:
        raise ReleasePendingError(rid, dest_name, dest_rid) from e
    record = MigrationRecord(
        rid=rid, dest_rid=dest_rid, dest=dest_name,
        pages=len(snap.pages), bytes=snap.nbytes(),
        duration_s=time.monotonic() - t0, stage=stage, ok=True,
    )
    if log is not None:
        log(
            f"migrated session {rid} -> {dest_name or 'peer'}#"
            f"{dest_rid}: {record.pages} pages, {record.bytes}B in "
            f"{record.duration_s * 1e3:.1f}ms"
        )
    return record


def drain_sessions(
    source,
    dests: Dict[str, object],
    *,
    transport: Optional[InProcessTransport] = None,
    log: Optional[Callable[[str], None]] = None,
) -> List[dict]:
    """Drain-with-migration: move every live session off ``source``
    to the peer with the most free pages (re-picked per session — one
    small peer must not absorb a whole drain).  Returns one report
    row per session: ``{"rid", "dest", "dest_rid", "tokens", "ok"}``
    — ``tokens`` carries the prompt so the router side can re-point
    the session's prefix-chain claims (router/core.py
    ``repoint_prompt``) instead of dropping them.

    A session that cannot move (budget-full peers, transport failure)
    is resumed and reported ``ok=False`` — the legacy wait-out drain
    covers it; migration never strands a client."""
    report: List[dict] = []
    for sess in source.sessions():
        rid = sess["rid"]
        ranked = sorted(
            dests.items(),
            key=lambda kv: -float(
                kv[1].stats().get("kv_pages_free", 0)
            ),
        )
        moved = False
        err: Optional[BaseException] = None
        for name, dest in ranked:
            if dest is source:
                continue
            try:
                record = migrate_session(
                    source, dest, rid, dest_name=name,
                    transport=transport, log=log,
                )
            except ReleasePendingError as e:
                # the session DID move — retry the release once and
                # report the move either way; trying another
                # destination here would double-splice
                try:
                    source.release_migrated(
                        rid, moved_to=e.moved_to, dest_rid=e.dest_rid
                    )
                except MigrationError:
                    pass
                report.append({
                    "rid": rid, "dest": e.moved_to,
                    "dest_rid": e.dest_rid,
                    "tokens": sess["tokens"], "ok": True,
                })
                moved = True
                break
            except (MigrationError, KeyError) as e:
                err = e
                continue
            report.append({
                "rid": rid, "dest": name,
                "dest_rid": record.dest_rid,
                "tokens": sess["tokens"], "ok": True,
            })
            moved = True
            break
        if not moved:
            report.append({
                "rid": rid, "dest": None, "dest_rid": -1,
                "tokens": sess["tokens"], "ok": False,
                "error": str(err) if err else "no destination",
            })
    return report


class PrefillHandoff:
    """The disaggregation hook: installed as ``PagedEngine(role=
    "prefill", handoff=...)``, called on the engine loop thread the
    moment a prompt finishes chunked prefill (first token sampled,
    row frozen).  Picks the decode pod with the most free pages and
    runs the migration protocol; returning None (no pool, move
    failed) makes the engine decode locally — a prefill pod degrades
    to unified rather than failing the request."""

    def __init__(
        self,
        decode_pods: Callable[[], Dict[str, object]],
        transport: Optional[InProcessTransport] = None,
        log: Optional[Callable[[str], None]] = None,
    ):
        self._decode_pods = decode_pods
        self._transport = transport
        self._log = log
        self.handoffs = 0
        self.fallbacks = 0

    def __call__(self, engine, rid: int) -> Optional[MigrationRecord]:
        pods = dict(self._decode_pods() or {})
        ranked = sorted(
            pods.items(),
            key=lambda kv: -float(
                kv[1].stats().get("kv_pages_free", 0)
            ),
        )
        for name, dest in ranked:
            if dest is engine:
                continue
            try:
                # freeze=fresh on every attempt: a previous failed
                # attempt's abort path resumed the row locally, and
                # the engine loop (our caller) cannot decode it in
                # between — re-fencing is free
                record = migrate_session(
                    engine, dest, rid, dest_name=name,
                    transport=self._transport, log=self._log,
                )
            except ReleasePendingError:
                raise  # the engine holds the frozen row for a retry
            except MigrationError:
                continue
            self.handoffs += 1
            return record
        self.fallbacks += 1
        return None
