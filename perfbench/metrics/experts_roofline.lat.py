"""The expert kernel's share of its roofline, in percent, over the traced
slices: the bytes and FLOPs of its calls (the ``"experts"`` part of the
decoder family's ``slice_work``: the chosen and the shared experts'
matrices, read once a step) on the published peaks, over the summed device
time of the kernels the configuration names as ``experts``."""
from perfbench import counts, devtrace


def read(run):
    if "experts" not in run.config["kernels"]:
        return None
    return counts.roof_share(run, "experts",
                             devtrace.kernel_seconds(run.slices, run.kernels("experts")))
