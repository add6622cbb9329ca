"""Device milliseconds a decode step: the CUDA-event time of the window's
``segment`` spans (the replays, between two host reads) over the steps
they ran (``span_readers.step_device_ms``)."""
from perfbench import span_readers


def read(run):
    return span_readers.step_device_ms(run)
