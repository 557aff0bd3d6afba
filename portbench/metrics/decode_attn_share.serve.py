"""decode_attn_share.serve: the device time of the work the decode step
launches inside ``trunk.kv_gather`` (the whole-table gather) or
``trunk.attend`` (widening, einsums, softmax; where a paged-attention
kernel replaces both, it runs there), over the device time of all the
work launched inside ``pool.decode`` ranges, in the traced window, in
percent."""

from portbench.lib.ranges import device_us_launched_in


def read(ctx, rec):
    got = device_us_launched_in(rec.trace, "pool.decode",
                                ["trunk.kv_gather", "trunk.attend"])
    if got is None or got[1] <= 0:
        return None
    return 100.0 * got[0] / got[1]
