"""engine_ttft_p95_s.serve: the engine's own time to first token
(``PagedEngine``: arrival in ``submit`` to the first token), its 95th
percentile as ``stats()`` gives it after the window's requests have
drained: over every request of the run, the pre-roll's with them (the
engine keeps its last 512 samples; a run sends fewer)."""


def read(ctx, rec):
    stats = rec.counters.get("engine") or {}
    value = stats.get("ttft_p95_s")
    return None if value is None else float(value)
