"""decode_hbm_roofline.serve: the paged decode step against the bytes
it needs, in percent: for each traced call, the least time to move
every weight once, the K/V of each active row's real positions once,
the new K/V and the logits (``Geometry.decode_bytes``) over the HBM
bandwidth, summed, over the device time of the work the call launched
(``models/decode.py`` ``paged_decode_step``)."""

from portbench.lib.peaks import bound

PREFIX = "portbench.decode#"


def read(ctx, rec):
    if rec.trace is None:
        return None
    g = ctx.geometry
    spent = rec.trace.device_s_in_ranges(PREFIX)
    calls = ctx.spans.of("decode")
    least, total = 0.0, 0.0
    for name, secs in spent.items():
        i = int(name[len(PREFIX):])
        if i >= len(calls) or secs <= 0:
            continue
        positions = calls[i][3]["positions"]
        if not positions:
            continue
        least += bound(g.decode_bytes(positions), g.decode_flops(positions),
                       g.dtype)[0]
        total += secs
    if total <= 0:
        return None
    return 100.0 * least / total
