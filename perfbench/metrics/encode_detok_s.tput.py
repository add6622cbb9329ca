"""Seconds a batch of the runner's fenced encode and detok phases
(``PhaseRunner.run``'s ``encode_s`` + ``detok_s``), over the window."""


def read(run):
    done = run.done()
    return sum(r["encode_s"] + r["detok_s"] for r in done) / len(done) if done else None
