"""Percent of the untraced decode with nothing running on the device: one
less the device's busy time a step in the traced slices (the union of its
operations' intervals) over the wall time a step of the window's requests
(their fenced ``decode_s`` over their steps). The profiler slows the
host's graph launches, so the traced slices' own gaps are the tracer's
as much as the program's; their busy time is not."""
from perfbench import devtrace


def read(run):
    done = run.done()
    steps = sum(s.pos1[0] - s.pos0[0] for s in run.slices)
    if not steps or not done:
        return None
    busy = sum(devtrace.busy_seconds(s) for s in run.slices) / steps
    wall = sum(r["decode_s"] for r in done) / sum(r["decode_steps"] for r in done)
    return 100.0 * (1.0 - busy / wall)
