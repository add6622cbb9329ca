"""Seconds a mesh: the window's length over the meshes written in it."""


def read(run):
    return run.window_s / run.meshes if run.meshes else None
