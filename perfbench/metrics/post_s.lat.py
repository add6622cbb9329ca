"""Seconds a mesh of post-processing (merge, clean-up, OBJ write), on the
harness clock around ``postprocess_faces``, over the window's meshes."""


def read(run):
    posts = [s for r in run.done() for s in r["post_s"]]
    return sum(posts) / len(posts) if posts else None
