"""Trace exporters: Chrome trace-event JSON and a plain-text timeline.

Chrome format (Perfetto/chrome://tracing loadable): one complete
("ph": "X") event per span, ``pid`` = service lane, ``tid`` = the
span's track (a pod instance like "trainer-2", "scheduler", "plan"),
timestamps in wall microseconds.  Worker steplogs merge in as extra
events on ``<task>/steps`` lanes, so a 4-host gang renders as four
step rows whose horizontal offsets ARE the gang skew.

The text form is the ssh-and-curl view: one line per span, sorted by
start, offsets relative to the first span.

Port of ``dcos_commons_tpu/trace/export.py``, line for line but the imports.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from dcos_commons_tpu_torch.trace.recorder import TraceRecorder
from dcos_commons_tpu_torch.trace.span import render_id

Steplogs = Dict[str, List[dict]]


def to_chrome(
    recorder: TraceRecorder,
    service: str = "scheduler",
    steplogs: Optional[Steplogs] = None,
) -> dict:
    """Chrome trace-event JSON object (round-trips ``json.loads``)."""
    service = service or recorder.service or "scheduler"
    events = []
    for span in recorder.snapshot():
        start_wall = recorder.wall_of(span.start_s)
        args = span.str_attrs()
        args["trace_id"] = render_id(span.trace_id)
        args["span_id"] = render_id(span.span_id)
        if span.parent_id:
            args["parent_id"] = render_id(span.parent_id)
        events.append({
            "name": span.name,
            "ph": "X",
            "pid": service,
            "tid": span.track or "scheduler",
            "ts": int(start_wall * 1e6),
            "dur": max(1, int(span.duration_s * 1e6)),
            "args": args,
        })
    for task_name, records in sorted((steplogs or {}).items()):
        for record in records:
            wall_s = float(record.get("wall_s", 0.0) or 0.0)
            end_wall = float(record.get("t", 0.0) or 0.0)
            events.append({
                "name": f"step {record.get('step', '?')}",
                "ph": "X",
                "pid": service,
                "tid": f"{task_name}/steps",
                "ts": int((end_wall - wall_s) * 1e6),
                "dur": max(1, int(wall_s * 1e6)),
                "args": {
                    k: v for k, v in record.items() if k not in ("t",)
                },
            })
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "service": service,
            "spans": len(recorder.snapshot()),
            "dropped": recorder.dropped,
        },
    }


def to_text(
    recorder: TraceRecorder,
    service: str = "scheduler",
    steplogs: Optional[Steplogs] = None,
    events: Optional[List[dict]] = None,
) -> str:
    """Human timeline: offset, duration, trace prefix, lane, name,
    attrs — one line per span/step, sorted by start.  ``events``
    (journal records from the health plane) render on a ``journal``
    lane, so operator verbs / failovers / detector alerts line up
    against the spans around them."""
    rows = []  # (wall_start, dur_s, trace, track, name, attrs)
    for span in recorder.snapshot():
        rows.append((
            recorder.wall_of(span.start_s),
            span.duration_s,
            # the distinct tail of the full id (the leading 8 chars are
            # the shared process prefix): greppable here AND a suffix
            # match for the full ids in the Chrome export
            render_id(span.trace_id)[-8:],
            span.track or "scheduler",
            span.name,
            span.str_attrs(),
        ))
    for task_name, records in sorted((steplogs or {}).items()):
        for record in records:
            wall_s = float(record.get("wall_s", 0.0) or 0.0)
            end_wall = float(record.get("t", 0.0) or 0.0)
            attrs = {k: v for k, v in record.items() if k not in ("t", "step")}
            rows.append((
                end_wall - wall_s,
                wall_s,
                "steplog",
                f"{task_name}/steps",
                f"step {record.get('step', '?')}",
                attrs,
            ))
    for event in events or []:
        attrs = {
            k: v for k, v in event.items()
            if k not in ("t", "kind", "seq", "message")
        }
        if event.get("message"):
            attrs["msg"] = event["message"]
        rows.append((
            float(event.get("t", 0.0) or 0.0),
            0.0,
            f"j{event.get('seq', '?')}",
            "journal",
            str(event.get("kind", "event")),
            attrs,
        ))
    rows.sort(key=lambda r: r[0])
    base = rows[0][0] if rows else 0.0
    lines = [
        f"# trace: {len(rows)} entries "
        f"({recorder.dropped} dropped from the ring buffer), "
        f"service={service or recorder.service or 'scheduler'}",
        "#   offset     duration  trace    lane                 name  attrs",
    ]
    for wall_start, dur_s, trace, track, name, attrs in rows:
        attr_text = " ".join(
            f"{k}={v}" for k, v in sorted(attrs.items())
        )
        lines.append(
            f"{wall_start - base:+10.3f}s {dur_s:9.6f}s {trace:<8} "
            f"{track:<20} {name} {attr_text}".rstrip()
        )
    return "\n".join(lines) + "\n"


def chrome_json(recorder: TraceRecorder, **kwargs) -> str:
    """Serialized convenience wrapper (CLI/file dumps)."""
    return json.dumps(to_chrome(recorder, **kwargs), indent=2)
