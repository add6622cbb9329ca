"""The plain reference of the mesh clean-up (the reference's ``main.py``
after generation: trimesh with merged primitives, unique faces) and an OBJ
reader, in NumPy.

The faces a mesh must end with, from its face coordinates: faces with a
NaN dropped, vertices equal in value merged, faces that repeat a vertex
dropped, and of faces with the same three vertices one kept. Winding is
left out of the comparison: a face is its set of three vertices.
"""
from __future__ import annotations

import numpy as np

DIGITS = 6          # the OBJ's coordinates are written to 8 decimals; grid steps are 1/128


def _key(v) -> tuple:
    return tuple(round(float(c), DIGITS) for c in v)


def expected_faces(face_coords: np.ndarray) -> tuple:
    """(set of faces, each a frozenset of three vertex tuples; the
    distinct vertices of every face without a NaN, which the merge keeps
    whether or not a face that survives uses them) from (faces, 3, 3)
    coordinates."""
    faces, corners = set(), set()
    for tri in np.asarray(face_coords, dtype=np.float64):
        if np.isnan(tri).any():
            continue
        verts = {_key(v) for v in tri}
        corners |= verts
        if len(verts) == 3:
            faces.add(frozenset(verts))
    return faces, corners


def read_obj(path: str) -> tuple:
    """(list of faces, each a frozenset of vertex tuples; number of 'v'
    lines) of an OBJ file."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append(_key(parts[1:4]))
            elif parts[0] == "f":
                faces.append(frozenset(verts[int(p.split("/")[0]) - 1] for p in parts[1:4]))
    return faces, len(verts)


def faces_off(face_coords: np.ndarray, obj_path: str) -> int:
    """How far an OBJ is from the clean-up of its face coordinates: faces
    missing or extra (a face listed twice counts), faces with fewer than
    three distinct vertices, and vertices missing or extra."""
    want, corners = expected_faces(face_coords)
    got, n_verts = read_obj(obj_path)
    got_set = set(got)
    bad = sum(1 for f in got if len(f) != 3)
    return (len(want ^ got_set) + (len(got) - len(got_set)) + bad
            + abs(n_verts - len(corners)))
