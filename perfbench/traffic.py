"""The traffic generator: one point cloud with normals a mesh, from the seed.

A traffic file (``perfbench/traffic/<cell>.json``) gives the mix's
parameters; this one generator reads every file:

  loop      "closed" (with ``clients`` 1): one client hands a batch to the
            program when the previous batch has returned, until the window
            has passed
  batch     meshes a request (rows of one ``PhaseRunner.run`` call)
  shape     the surfaces the points lie on: a union of ``parts`` (a range)
            ellipsoids with semi-axes in ``axes`` (a range), each randomly
            rotated and placed within ``spread`` of the origin
  check     the sample of finished requests that the comparison reads:
            ``requests`` requests (the longest first, the latest of
            those, whose KV cache is still there to read), ``rows`` rows
            of each, drawn from the seed, one from each half of the batch
            where there are two or more
  trace     the traced request's slices: ``at``, fractions of its decode
            where a slice starts, each ``span`` replay calls long

Every mesh of every seed gets the same number of points (the
configuration's ``num_points``) and the same decode length, so a seed
changes which points and weights, not how much work. Points are
normalised as the reference's ``Dataset`` does (``main.py``): centred on
the bounding box, scaled so the largest coordinate is 0.9995, float16.
"""
from __future__ import annotations

import numpy as np

LOOPS = ("closed",)


def check_traffic(traffic: dict) -> dict:
    if traffic.get("loop") not in LOOPS or traffic.get("clients") != 1:
        raise ValueError(f"traffic loop {traffic.get('loop')!r} with {traffic.get('clients')} "
                         f"clients: the generator runs {LOOPS} with one client")
    if int(traffic["batch"]) < 1:
        raise ValueError("traffic batch must be at least 1")
    return traffic


def _rotation(rng: np.random.Generator) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    return q * np.sign(np.diag(r))


def point_cloud(traffic: dict, seed: int, index: int, num_points: int) -> np.ndarray:
    """Mesh ``index`` of the run with ``seed``: (num_points, 6) float16,
    points then unit normals."""
    rng = np.random.default_rng([seed % (1 << 64), index])
    shape = traffic["shape"]
    lo, hi = shape["parts"]
    parts = int(rng.integers(lo, hi + 1))
    owner = rng.integers(0, parts, num_points)
    pts = np.empty((num_points, 3))
    nrm = np.empty((num_points, 3))
    for k in range(parts):
        sel = owner == k
        u = rng.standard_normal((int(sel.sum()), 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        axes = rng.uniform(*shape["axes"], 3)
        rot = _rotation(rng)
        centre = rng.uniform(-shape["spread"], shape["spread"], 3)
        pts[sel] = (u * axes) @ rot.T + centre
        n = (u / axes) @ rot.T          # the ellipsoid's normal: A^-T u, A = rot diag(axes)
        nrm[sel] = n / np.linalg.norm(n, axis=1, keepdims=True)
    return normalize(np.concatenate([pts, nrm], axis=1))


def normalize(pc_normal: np.ndarray, scale: float = 0.9995) -> np.ndarray:
    """Centre on the bounding box's midpoint, scale so that max |coord| is
    ``scale``, check unit normals, float16."""
    coords = pc_normal[:, :3].astype(np.float64)
    coords = coords - (coords.min(axis=0) + coords.max(axis=0)) / 2
    coords = coords / np.abs(coords).max() * scale
    normals = pc_normal[:, 3:]
    if not (np.linalg.norm(normals, axis=-1) > 0.99).all():
        raise ValueError("normals should be unit vectors")
    return np.concatenate([coords, normals], axis=-1).astype(np.float16)


def batch(traffic: dict, seed: int, request: int, num_points: int) -> np.ndarray:
    """Request ``request``'s rows: (batch, num_points, 6) float32."""
    b = int(traffic["batch"])
    return np.stack([point_cloud(traffic, seed, request * b + r, num_points)
                     for r in range(b)]).astype(np.float32)


def check_sample(traffic: dict, seed: int, steps: list) -> list:
    """(request, row) pairs to compare, from the requests' decode steps:
    the longest request first (the latest of equals), then others drawn
    from the seed; in each, ``rows`` rows drawn from the seed, spread over
    the batch's halves."""
    rng = np.random.default_rng([seed % (1 << 64), 1 << 20])
    want = traffic["check"]
    order = sorted(range(len(steps)), key=lambda i: (-steps[i], -i))
    chosen = order[:1] + list(rng.permutation(order[1:]))
    b = int(traffic["batch"])
    halves = [range(0, b)] if b < 2 else [range(0, b // 2), range(b // 2, b)]
    pairs = []
    for req in chosen[:want["requests"]]:
        for k in range(min(want["rows"], b)):
            pairs.append((req, int(rng.choice(list(halves[k % len(halves)])))))
    return pairs
