"""attn_kernels_roofline.train: kernels K2-K4 (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) against their roofline, in percent: the sum over
the traced launches of each launch's least time (the larger of its
operations over the bf16 peak and its bytes over the HBM bandwidth,
from the step's shapes) over the sum of their device times."""

from portbench.lib import counts
from portbench.lib.peaks import bound
from portbench.lib.trace import PORT_KERNELS


def read(ctx, rec):
    if rec.trace is None:
        return None
    g, mix = ctx.geometry, ctx.mix
    bh, s, hd, item = mix["batch"] * g.n_heads, mix["seq"], g.head_dim, \
        g.itemsize
    per_launch = {
        "K2": bound(counts.flash_fwd_bytes(bh, s, hd, item),
                    counts.flash_fwd_flops(bh, s, hd), g.dtype)[0],
        "K3": bound(counts.flash_dq_bytes(bh, s, hd, item),
                    counts.flash_dq_flops(bh, s, hd), g.dtype)[0],
        "K4": bound(counts.flash_dkv_bytes(bh, s, hd, item),
                    counts.flash_dkv_flops(bh, s, hd), g.dtype)[0],
    }
    least, spent = 0.0, 0.0
    for k, t in per_launch.items():
        n, secs = rec.trace.kernels(PORT_KERNELS[k])
        least += n * t
        spent += secs
    if spent <= 0:
        return None
    return 100.0 * least / spent
