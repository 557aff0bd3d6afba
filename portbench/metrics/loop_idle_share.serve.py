"""loop_idle_share.serve: the share of the traced window's wall time in
which the card runs nothing and the engine's loop thread is inside no
``pool.*`` range (the engine's own Python between the pool's calls,
which end in a copy to the host, so the card has drained), in percent.
With ``pool_idle_share.serve`` it splits ``device_idle_share.serve``."""

from portbench.lib.ranges import idle_split, share_of_window


def read(ctx, rec):
    split = idle_split(rec.trace)
    if split is None:
        return None
    return share_of_window(rec.trace, split[0])
