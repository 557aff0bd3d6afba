"""pool_idle_share.serve: the share of the traced window's wall time in
which the card runs nothing while the engine's loop thread is inside a
``pool.*`` range (the eager step's launch gaps, the sampling's copy to
the host), in percent.  With ``loop_idle_share.serve`` it splits
``device_idle_share.serve``."""

from portbench.lib.ranges import idle_split, share_of_window


def read(ctx, rec):
    split = idle_split(rec.trace)
    if split is None:
        return None
    return share_of_window(rec.trace, split[1])
