"""The port's host utilities held to the JAX package: ``utils/io.py``
(round trips, and the textured OBJ / MTL / PNG and ``MeshOutput`` files
byte-equal to JAX's), the HTML viewer (byte-equal), the wireframe
renderer's matplotlib backend (pixel-equal to JAX's; an ImportError that
names the backend, and no file, where matplotlib is missing),
``discretize`` / ``undiscretize`` (exact), and ``sample_surface_torch``,
which draws from a torch.Generator and so is held by its distribution:
face frequencies within 5 standard errors of the area shares (a
degenerate face never drawn), every point on its face, unit face normals,
and the per-face point means within 5 standard errors of the centroids."""
import builtins
import io
import os
import tarfile

import numpy as np
import pytest
import torch

from meshanything_tpu.geometry import normalize as jnorm
from meshanything_tpu.runtime import html_viewer as jhtml
from meshanything_tpu.runtime import render as jrender
from meshanything_tpu.utils import io as jio
from meshanything_tpu_torch.geometry import (
    discretize,
    sample_surface_torch,
    sample_surface_with_normals,
    undiscretize,
)
from meshanything_tpu_torch.runtime import html_viewer, render
from meshanything_tpu_torch.utils import io as pio

CUBE_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                   [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
CUBE_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                   [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])


def _bytes(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def test_json_npy_npz_roundtrips(tmp_path):
    p = str(tmp_path / "a" / "b")
    assert pio.mkdir(p) == p and os.path.isdir(p)
    pio.write_json(str(tmp_path / "ours.json"), {"k": [1, 2], "s": "x"})
    jio.write_json(str(tmp_path / "ref.json"), {"k": [1, 2], "s": "x"})
    assert _bytes(tmp_path / "ours.json") == _bytes(tmp_path / "ref.json")
    assert pio.load_json(str(tmp_path / "ours.json")) == {"k": [1, 2], "s": "x"}
    assert pio.json_loads('{"a": 1}') == {"a": 1}
    arr = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, arr)
    np.testing.assert_array_equal(pio.npy_loads(buf.getvalue()), arr)
    buf = io.BytesIO()
    np.savez(buf, a=arr)
    np.testing.assert_array_equal(pio.npz_loads(buf.getvalue())["a"], arr)


def test_extract_tar(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    tar_path = str(tmp_path / "shard.tar")
    with tarfile.open(tar_path, "w") as tar:
        for name, text in (("u2.txt", "y"), ("u1.txt", "x")):
            (src / name).write_text(text)
            tar.add(str(src / name), arcname=name)
    assert pio.extract_tar(tar_path, str(tmp_path / "ours")) == ["u1.txt", "u2.txt"]
    assert (tmp_path / "ours" / "u2.txt").read_text() == "y"


def test_textured_obj_is_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(1)
    uvs = rng.uniform(size=(8, 2))
    tex = rng.integers(0, 256, size=(4, 6, 3)).astype(np.uint8)
    for package, sub in ((pio, "ours"), (jio, "ref")):
        (tmp_path / sub).mkdir()
        package.save_textured_obj(CUBE_V, uvs, CUBE_F, CUBE_F, tex, str(tmp_path / sub / "m.obj"))
    for name in ("m.obj", "m.mtl", "m.png"):
        assert _bytes(tmp_path / "ours" / name) == _bytes(tmp_path / "ref" / name), name
    assert b"map_Kd m.png" in _bytes(tmp_path / "ours" / "m.mtl")


@pytest.mark.parametrize("kind", ["textured", "vertex_colors", "plain"])
def test_mesh_output_dispatch_is_byte_equal_to_jax(tmp_path, kind):
    rng = np.random.default_rng(2)
    kw = {}
    if kind == "textured":
        kw = dict(uvs=rng.uniform(size=(8, 2)), mesh_tex_idx=CUBE_F,
                  tex_map=rng.integers(0, 256, size=(4, 4, 3)).astype(np.uint8))
    elif kind == "vertex_colors":
        kw = dict(vertex_colors=rng.integers(0, 256, size=(8, 3)))
    ours, ref = pio.MeshOutput(CUBE_V, CUBE_F, **kw), jio.MeshOutput(CUBE_V, CUBE_F, **kw)
    assert ours.contain_uv_texture() == (kind == "textured")
    assert ours.contain_vertex_colors() == (kind == "vertex_colors")
    for out, sub in ((ours, "ours"), (ref, "ref")):
        (tmp_path / sub).mkdir()
        out.export(str(tmp_path / sub / "m.obj"))
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "ref"))
    for name in os.listdir(tmp_path / "ours"):
        assert _bytes(tmp_path / "ours" / name) == _bytes(tmp_path / "ref" / name), name


@pytest.mark.parametrize("title", ["meshanything_tpu", "a <b> & c"])
def test_html_viewer_is_byte_equal_to_jax(tmp_path, title):
    v = np.random.default_rng(3).normal(size=(30, 3)) * 5 + 2
    f = np.random.default_rng(4).integers(0, 30, size=(40, 3))
    ours = html_viewer.export_html_viewer(v, f, str(tmp_path / "ours.html"), title=title)
    ref = jhtml.export_html_viewer(v, f, str(tmp_path / "ref.html"), title=title)
    assert _bytes(ours) == _bytes(ref)
    empty = html_viewer.export_html_viewer(np.zeros((0, 3)), np.zeros((0, 3), int),
                                           str(tmp_path / "e.html"))
    assert _bytes(empty) == _bytes(jhtml.export_html_viewer(
        np.zeros((0, 3)), np.zeros((0, 3), int), str(tmp_path / "e_ref.html")))


def test_matplotlib_backend_is_pixel_equal_to_jax(tmp_path):
    import matplotlib.image as mpimg

    ours = render.wireframe_render(CUBE_V, CUBE_F, str(tmp_path / "ours.png"), dpi=40,
                                   backend="matplotlib")
    ref = jrender.wireframe_render(CUBE_V, CUBE_F, str(tmp_path / "ref.png"), dpi=40,
                                   backend="matplotlib")
    a, b = mpimg.imread(ours), mpimg.imread(ref)
    assert a.shape == b.shape and a.shape[1] > a.shape[0]      # two views side by side
    np.testing.assert_array_equal(a, b)
    # the numpy backend is the default and stays pixel-equal too
    np.testing.assert_array_equal(
        mpimg.imread(render.wireframe_render(CUBE_V, CUBE_F, str(tmp_path / "n.png"), dpi=40)),
        mpimg.imread(jrender.wireframe_render(CUBE_V, CUBE_F, str(tmp_path / "nr.png"), dpi=40)))
    with pytest.raises(ValueError, match="backend"):
        render.wireframe_render(CUBE_V, CUBE_F, str(tmp_path / "x.png"), backend="svg")


def test_matplotlib_backend_without_matplotlib_raises(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    out = tmp_path / "wire.png"
    with pytest.raises(ImportError, match="backend='matplotlib'"):
        render.wireframe_render(CUBE_V, CUBE_F, str(out), backend="matplotlib")
    assert not out.exists()                 # no fallback to the numpy renderer


def test_discretize_undiscretize_match_jax():
    t = np.random.default_rng(5).uniform(-0.7, 0.7, size=(200, 3))
    for kw in ({}, {"num_discrete": 64}, {"low": -1.0, "high": 1.0, "num_discrete": 7}):
        bins = discretize(t, **kw)
        np.testing.assert_array_equal(bins, jnorm.discretize(t, **kw))
        back = undiscretize(bins, **kw)
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, jnorm.undiscretize(bins, **kw))
    assert discretize(np.array([-5.0, 5.0])).tolist() == [0, 127]


def _planes_mesh():
    """Two triangles of areas 2 and 0.5 in different planes, and a
    degenerate one (area 0)."""
    v = torch.tensor([[0, 0, 0], [2, 0, 0], [0, 2, 0],              # area 2, normal +z
                      [0, 0, 1], [0, 1, 1], [0, 0, 2],              # area 0.5, normal +x
                      [3, 3, 3], [4, 4, 4], [5, 5, 5]], dtype=torch.float64)
    f = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    return v, f


def test_sample_surface_torch_distribution():
    v, f = _planes_mesh()
    n = 40000
    out = sample_surface_torch(torch.Generator().manual_seed(0), v, f, n)
    assert out.shape == (n, 6) and out.dtype == torch.float64
    pts, nrm = out[:, :3].numpy(), out[:, 3:].numpy()
    on_z = np.isclose(pts[:, 2], 0.0)
    on_x = np.isclose(pts[:, 0], 0.0) & ~on_z
    assert on_z.sum() + on_x.sum() == n                 # the degenerate face is never drawn
    share, se = on_z.mean(), np.sqrt(0.8 * 0.2 / n)
    assert abs(share - 0.8) < 5 * se                    # area 2 of 2.5
    np.testing.assert_allclose(nrm[on_z], np.tile([0, 0, 1.0], (on_z.sum(), 1)), atol=1e-12)
    np.testing.assert_allclose(nrm[on_x], np.tile([1.0, 0, 0], (on_x.sum(), 1)), atol=1e-12)
    # inside each triangle, uniformly: the mean point is the centroid
    z = pts[on_z]
    assert (z[:, 0] >= 0).all() and (z[:, 1] >= 0).all() and (z[:, :2].sum(1) <= 2 + 1e-9).all()
    for sel, centroid in ((z[:, :2], [2 / 3, 2 / 3]), (pts[on_x][:, 1:], [1 / 3, 4 / 3])):
        se = sel.std(axis=0) / np.sqrt(len(sel))
        assert (np.abs(sel.mean(axis=0) - centroid) < 5 * se).all()
    # the host sampler draws from the same distribution
    host = sample_surface_with_normals(v.numpy(), f.numpy(), n, np.random.default_rng(0))
    host_share = np.isclose(host[:, 2].astype(np.float64), 0.0, atol=1e-3).mean()
    assert abs(host_share - share) < 5 * np.sqrt(2 * 0.8 * 0.2 / n)


def test_sample_surface_torch_generator_and_dtype():
    v, f = _planes_mesh()
    a, b, c = (sample_surface_torch(torch.Generator().manual_seed(s), v.float(), f, 64)
               for s in (1, 1, 2))
    assert a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
