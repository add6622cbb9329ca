"""Percent of each cycle of the closed loop (one window request's start
to the next one's) outside the device time of the request's decode
``segment`` spans (``span_readers.cycle_idle``): the device's idle time,
with the encode, prefill and detok counted whole. Those phases run
eagerly and the host's launching sets their length, so their event times
are no measure of the device's work there (a few ms a cycle)."""
from perfbench import span_readers


def read(run):
    return span_readers.cycle_idle(run)
