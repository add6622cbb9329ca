"""Milliseconds a request's prefill (the condition's prefill, the first
token and the refill of the kept state) takes on the stream: the
``prefill`` span's event-to-event time, over the window's requests
(``span_readers.prefill_ms``). A latency, not the device's work: the
prefill runs eagerly, so the host's launching sets most of it."""
from perfbench import span_readers


def read(run):
    return span_readers.prefill_ms(run)
