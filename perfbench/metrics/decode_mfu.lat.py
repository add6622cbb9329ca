"""The whole decode's share of the chip's peak, in percent: its least time
on the published peaks (the decoder family's ``decode_work``, through
``counts.decode_mfu``) over the fenced ``decode_s``."""
from perfbench import counts


def read(run):
    return counts.decode_mfu(run)
