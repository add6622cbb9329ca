"""The whole decode's share of the chip's peak, in percent: its least time
on the published peaks (``counts.decode_work``) over the fenced ``decode_s``."""
from perfbench import counts


def read(run):
    return counts.decode_mfu(run)
