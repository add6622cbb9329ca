"""Seconds from the process's start to the window's start: loading, weights,
kernel builds, graph capture and warm-up."""


def read(run):
    return run.setup_s
