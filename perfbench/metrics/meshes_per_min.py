"""Meshes written a minute: the meshes of the window over its length."""


def read(run):
    return 60.0 * run.meshes / run.window_s if run.meshes else None
