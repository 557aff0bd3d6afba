"""rmsnorm_roofline.train: kernel K1 (``csrc/rmsnorm.cu``) against its
roofline, in percent: its launches' least time (x and w read, y
written, over the HBM bandwidth; every launch of the step is ``[batch
x seq, d_model]``) over their device time."""

from portbench.lib import counts
from portbench.lib.peaks import bound
from portbench.lib.trace import PORT_KERNELS


def read(ctx, rec):
    if rec.trace is None:
        return None
    g, mix = ctx.geometry, ctx.mix
    n, secs = rec.trace.kernels(PORT_KERNELS["K1"])
    if not n or secs <= 0:
        return None
    rows = mix["batch"] * mix["seq"]
    least = bound(counts.rmsnorm_bytes(rows, g.d_model, g.itemsize), 0.0,
                  g.dtype)[0]
    return 100.0 * n * least / secs
