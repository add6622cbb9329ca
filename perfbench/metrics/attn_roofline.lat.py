"""The attention kernel's share of its roofline, in percent, over the traced
slices: the bytes and FLOPs its calls need (the ``"attention"`` part of the
decoder family's ``slice_work``) on the published peaks, over its summed device time."""
from perfbench import counts, devtrace


def read(run):
    return counts.roof_share(run, "attention",
                             devtrace.kernel_seconds(run.slices, run.kernels("attention")))
