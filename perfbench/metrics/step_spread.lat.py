"""The slowest window request's device milliseconds a step (its
``segment`` spans) over the fastest one's, less one, in percent
(``span_readers.step_spread``)."""
from perfbench import span_readers


def read(run):
    return span_readers.step_spread(run)
