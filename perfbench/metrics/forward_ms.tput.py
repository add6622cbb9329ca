"""Milliseconds a decode step: the runner's fenced ``decode_s`` over its
steps, summed over the window's requests."""


def read(run):
    done = run.done()
    steps = sum(r["decode_steps"] for r in done)
    return 1e3 * sum(r["decode_s"] for r in done) / steps if steps else None
