"""Training data transforms — webdataset-style dict pipeline (a numpy
copy of ``meshanything_tpu/training/transforms.py``).

Rebuilds the reference's vendored data pipeline (dead code,
michelangelo/data/transforms.py):
  * RandomSample (:85-127) — pick one surface set, subsample
    volume/near query points, concat [xyz | label] into geo_points;
  * SplitRandomSample (:130-180) — optionally subsample the surface too,
    keep vol/near separate;
  * FeatureSelection (:183-198) — select xyz / watertight-normal /
    normal feature columns;
  * AxisScaleTransform (:201-232) — random per-axis scale, renormalize
    to the unit cube, jitter surface points;
  * Compose (:341-383) + build_transforms (:392-407) — here a simple
    name registry instead of importlib target-string reflection (the
    framework's config style, see config.py docstring).

NumPy end to end: transforms run on the host side of the input
pipeline; the device only ever sees fixed-shape arrays.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np


class RandomSample:
    def __init__(self, num_volume_samples: int = 1024, num_near_samples: int = 1024):
        self.num_volume_samples = num_volume_samples
        self.num_near_samples = num_near_samples

    def __call__(self, sample: dict, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        total_surface = sample["surface"]
        # one of the stored surface sets (transforms.py:99-101)
        ind = rng.choice(total_surface.shape[0])
        surface = total_surface[ind]

        vp, vl = sample["vol_points"], sample["vol_label"]
        ind = rng.choice(vp.shape[0], self.num_volume_samples, replace=False)
        vol = np.concatenate([vp[ind], vl[ind][:, None]], axis=1)

        npts, nl = sample["near_points"], sample["near_label"]
        ind = rng.choice(npts.shape[0], self.num_near_samples, replace=False)
        near = np.concatenate([npts[ind], nl[ind][:, None]], axis=1)

        return {"surface": surface, "geo_points": np.concatenate([vol, near], axis=0)}


class SplitRandomSample:
    def __init__(self, use_surface_sample: bool = False,
                 num_surface_samples: int = 4096,
                 num_volume_samples: int = 1024,
                 num_near_samples: int = 1024):
        self.use_surface_sample = use_surface_sample
        self.num_surface_samples = num_surface_samples
        self.num_volume_samples = num_volume_samples
        self.num_near_samples = num_near_samples

    def __call__(self, sample: dict, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        surface = sample["surface"]
        if self.use_surface_sample:
            ind = rng.choice(surface.shape[0], self.num_surface_samples, replace=False)
            surface = surface[ind]

        vp, vl = sample["vol_points"], sample["vol_label"]
        ind = rng.choice(vp.shape[0], self.num_volume_samples, replace=False)
        vol = np.concatenate([vp[ind], vl[ind][:, None]], axis=1)

        npts, nl = sample["near_points"], sample["near_label"]
        ind = rng.choice(npts.shape[0], self.num_near_samples, replace=False)
        near = np.concatenate([npts[ind], nl[ind][:, None]], axis=1)

        return {"surface": surface, "vol_points": vol, "near_points": near}


class FeatureSelection:
    VALID_SURFACE_FEATURE_DIMS = {
        "none": [0, 1, 2],                        # xyz
        "watertight_normal": [0, 1, 2, 3, 4, 5],  # xyz + watertight normal
        "normal": [0, 1, 2, 6, 7, 8],             # xyz + original normal
    }

    def __init__(self, surface_feature_type: str):
        self.surface_feature_type = surface_feature_type
        self.surface_dims = self.VALID_SURFACE_FEATURE_DIMS[surface_feature_type]

    def __call__(self, sample: dict, rng=None) -> dict:
        sample = dict(sample)
        sample["surface"] = sample["surface"][:, self.surface_dims]
        return sample


class AxisScaleTransform:
    def __init__(self, interval=(0.75, 1.25), jitter: bool = True,
                 jitter_scale: float = 0.005):
        self.min_val, self.max_val = interval
        self.inter_size = interval[1] - interval[0]
        self.jitter = jitter
        self.jitter_scale = jitter_scale

    def __call__(self, sample: dict, rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        sample = dict(sample)
        surface = np.array(sample["surface"], dtype=np.float64)
        geo = np.array(sample["geo_points"], dtype=np.float64)

        scaling = rng.uniform(size=(1, 3)) * self.inter_size + self.min_val
        surface[..., :3] *= scaling
        geo[..., :3] *= scaling

        scale = (1.0 / np.abs(surface[..., :3]).max()) * 0.999999
        surface[..., :3] *= scale
        geo[..., :3] *= scale

        if self.jitter:
            surface[..., :3] += self.jitter_scale * rng.normal(size=surface[..., :3].shape)
            surface[..., :3] = np.clip(surface[..., :3], -1.015, 1.015)

        sample["surface"] = surface
        sample["geo_points"] = geo
        return sample


class Compose:
    """Sequential transform composition (transforms.py:341-383)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, sample, rng: Optional[np.random.Generator] = None):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample

    def __repr__(self):
        inner = "\n".join(f"    {t.__class__.__name__}" for t in self.transforms)
        return f"Compose(\n{inner}\n)"


_REGISTRY: Dict[str, type] = {
    "RandomSample": RandomSample,
    "SplitRandomSample": SplitRandomSample,
    "FeatureSelection": FeatureSelection,
    "AxisScaleTransform": AxisScaleTransform,
}


def identity(sample, rng=None):
    return sample


def build_transforms(cfg: Optional[Dict[str, dict]]):
    """Name->kwargs mapping -> composed pipeline (the reference resolves
    importlib target strings, transforms.py:392-407; a plain registry is
    the deliberate config redesign here)."""
    if not cfg:
        return identity
    transforms = []
    for name, kwargs in cfg.items():
        cls = _REGISTRY.get(name.rsplit(".", 1)[-1])
        if cls is None:
            raise KeyError(f"unknown transform {name!r}; known: {sorted(_REGISTRY)}")
        transforms.append(cls(**(kwargs or {})))
    return Compose(transforms)
