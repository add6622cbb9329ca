"""Percent of the decode loop's host time (its ``decode`` spans) with the
device idle: not covered by the CUDA-event time of its ``segment`` spans,
the host's read and relaunch between segments, in the window's untraced
requests (``span_readers.loop_idle``)."""
from perfbench import span_readers


def read(run):
    return span_readers.loop_idle(run)
