"""The dense-matrix kernels' share of their roofline, in percent, over the
traced slices: the decoder's matrices a step (the ``"gemm"`` part of the decoder
family's ``slice_work``) on the published peaks, over the
summed device time of the kernels the configuration names as GEMMs."""
from perfbench import counts, devtrace


def read(run):
    return counts.roof_share(run, "gemm", devtrace.kernel_seconds(run.slices, run.kernels("gemm")))
