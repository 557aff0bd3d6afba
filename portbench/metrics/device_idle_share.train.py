"""device_idle_share.train: the share of the traced steps' wall time in
which no kernel, copy or set ran on the card, in percent."""


def read(ctx, rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
