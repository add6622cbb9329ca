"""The port's VAE reconstruction (``runtime/recon.py``) and its CLI
(``miche_cli.py``) held to the JAX package on the same weights, on a small
``PerceiverConfig``, in f32.

Occupancy logits are held at 1e-5 absolute and relative (the f32
perceiver through its cross-attention; ~1e-6 measured), and every logit
larger than that tolerance must have the same sign in both packages: a
logit within it of zero may flip, and then the tetrahedra that touch it
differ. So meshes are compared (faces equal, vertices at 1e-4) only
where both packages emitted the same number of faces. The CLI's latents
are held at 1e-5; its OBJs by face count.

The CLI tests give both packages one seeded safetensors file under the
reference's perceiver key names, whose occupancy output projection is
scaled to a unit spread of the logits over the CLI's grid and whose bias
moves the zero level near their median, into a gap that no logit comes
within twice the tolerance of: about half the grid is inside and the level
set crosses (random weights need not cross), and no sign can flip."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.numpy import save_file

import meshanything_tpu.config as jconfig
from meshanything_tpu import miche_cli as jmiche
from meshanything_tpu.config import PerceiverConfig as JPerceiverConfig
from meshanything_tpu.models import perceiver as jper
from meshanything_tpu.runtime import recon as jrecon
import meshanything_tpu_torch.config as config
from meshanything_tpu_torch import miche_cli
from meshanything_tpu_torch.config import MeshAnythingConfig, PerceiverConfig
from meshanything_tpu_torch.geometry import load_obj
from meshanything_tpu_torch.models import perceiver as per
from meshanything_tpu_torch.runtime import checkpoint as ckpt
from meshanything_tpu_torch.runtime import recon

LOGIT_ATOL = 1e-5
LATENT_ATOL = 1e-5
MESH_ATOL = 1e-4

PER = dict(num_latents=8, embed_dim=8, width=48, heads=4, num_encoder_layers=1,
           num_decoder_layers=1, num_points=32)
CLI_POINTS = 256
CLI_DEPTH = 5


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = JPerceiverConfig(**PER), PerceiverConfig(**PER)
    params = jax.jit(jper.init_perceiver_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    model = ckpt.perceiver_from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jcfg, cfg, params, model


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_logits(params, jcfg, decoded, xyz, num_chunks):
    """The logits as JAX's extract_geometry computes them: jitted chunks,
    the last padded with zeros to ``num_chunks``."""
    query = jax.jit(lambda p, q, lat: jper.query_geometry(p, jcfg, q, lat))
    b, parts = decoded.shape[0], []
    for start in range(0, len(xyz), num_chunks):
        chunk = xyz[start:start + num_chunks]
        pad = num_chunks - len(chunk)
        chunk = np.concatenate([chunk, np.zeros((pad, 3))])
        q = jnp.broadcast_to(jnp.asarray(chunk, decoded.dtype)[None], (b, num_chunks, 3))
        out = np.asarray(query(params, q, decoded).astype(jnp.float32))
        parts.append(out[:, :num_chunks - pad])
    return np.concatenate(parts, axis=1)


def assert_logits_agree(ours, ref):
    np.testing.assert_allclose(ours, ref, atol=LOGIT_ATOL, rtol=LOGIT_ATOL)
    big = np.abs(ref) > LOGIT_ATOL
    np.testing.assert_array_equal(np.sign(ours[big]), np.sign(ref[big]))


def clear_level(logits) -> float:
    """A level near the median that no logit comes within 2x the tolerance
    of: the middle of the widest gap between consecutive sorted logits in
    the middle tenth (about half the grid inside, the surface crossing)."""
    s = np.sort(np.ravel(logits))
    lo, hi = int(0.45 * len(s)), int(0.55 * len(s))
    k = lo + int(np.argmax(np.diff(s[lo:hi])))
    assert s[k + 1] - s[k] > 4 * LOGIT_ATOL
    return float(0.5 * (s[k] + s[k + 1]))


def assert_meshes_agree(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if a is not None and len(a.faces) == len(b.faces):
            np.testing.assert_array_equal(a.faces, b.faces)
            np.testing.assert_allclose(a.vertices, b.vertices, atol=MESH_ATOL)


def test_dense_grid_points_match_jax():
    lo, hi = np.array([-1.0, -0.5, -1.1]), np.array([1.0, 0.5, 1.1])
    ours = recon.generate_dense_grid_points(lo, hi, 3)
    ref = jrecon.generate_dense_grid_points(lo, hi, 3)
    assert ours[2] == ref[2] == [9, 9, 9]
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[0][1], [-1.0, -0.5, -1.1 + 2.2 / 8])   # ij: z fastest


@pytest.mark.parametrize("num_chunks", [512, 10000])
def test_extract_geometry_logits_and_meshes_match_jax(setup, num_chunks):
    jcfg, cfg, params, model = setup
    kl = np.random.default_rng(0).normal(size=(2, 8, 8)).astype(np.float32)
    jdec = jper.decode_latents(params, jcfg, jnp.asarray(kl))
    with torch.no_grad():
        dec = per.decode_latents(model, cfg, torch.from_numpy(kl))
    np.testing.assert_allclose(_np(dec), np.asarray(jdec), atol=LOGIT_ATOL, rtol=LOGIT_ATOL)
    xyz, grid_size, lo, hi = recon.grid(1.1, 4)
    ours = recon.occupancy_logits(model, cfg, dec, xyz, num_chunks)
    ref = jax_logits(params, jcfg, jdec, xyz, num_chunks)
    assert ours.shape == (2, 17 ** 3) and ours.dtype == np.float32
    assert_logits_agree(ours, ref)
    # a level the fields cross, clear of every logit
    shift = clear_level(ref)
    assert_meshes_agree(recon.meshes_from_logits(ours - shift, grid_size, lo, hi),
                        recon.meshes_from_logits(ref - shift, grid_size, lo, hi))
    assert_meshes_agree(recon.extract_geometry(model, cfg, dec, octree_depth=4,
                                               num_chunks=num_chunks),
                        jrecon.extract_geometry(params, jcfg, jdec, octree_depth=4,
                                                num_chunks=num_chunks))


def test_meshes_from_logits_none_and_raise(monkeypatch):
    xyz, grid_size, lo, hi = recon.grid(1.1, 2)
    outside = -np.ones((1, len(xyz)), np.float32)
    assert recon.meshes_from_logits(outside, grid_size, lo, hi) == [None]
    field = np.where(np.linalg.norm(xyz, axis=1) < 0.6, 1.0, -1.0)[None].astype(np.float32)
    sphere = recon.meshes_from_logits(field, grid_size, lo, hi)[0]
    assert len(sphere.faces) > 0 and np.abs(sphere.vertices).max() <= 1.1

    def boom(field, level):
        raise RuntimeError("marching failed")

    monkeypatch.setattr(recon, "marching_tetrahedra", boom)
    assert recon.meshes_from_logits(field, grid_size, lo, hi) == [None]


def test_reconstruct_from_pc_matches_jax(setup):
    jcfg, cfg, params, model = setup
    pc = (np.random.default_rng(1).normal(size=(1, 32, 6)) * 0.4).astype(np.float32)
    ours = recon.reconstruct_from_pc(model, cfg, torch.from_numpy(pc), octree_depth=4)
    ref = jrecon.reconstruct_from_pc(params, jcfg, jnp.asarray(pc), octree_depth=4)
    assert_meshes_agree(ours, ref)


# ---------------------------------------------------------------------------
# miche_cli, both packages on one file


def sphere_surface(path: str, n: int = 600) -> str:
    """A seeded unit-sphere point cloud with its normals (.npz, the
    reference's points + normals keys)."""
    rng = np.random.default_rng(2)
    p = rng.normal(size=(n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    np.savez(path, points=(p * 0.8).astype(np.float32), normals=p.astype(np.float32))
    return path


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """(input .npz, a perceiver file under the reference's key names whose
    output projection puts the level at ``clear_level`` of the CLI's grid)."""
    tmp = tmp_path_factory.mktemp("miche")
    cfg = PerceiverConfig(**PER)
    surface = sphere_surface(str(tmp / "sphere.npz"))
    shapes = {k: s for k, s in ckpt.reference_key_shapes(MeshAnythingConfig(perceiver=cfg)).items()
              if k.startswith(miche_cli.PERCEIVER_PREFIX)}
    rng = np.random.default_rng(3)
    sd = {k: (rng.normal(size=s) * 0.05).astype(np.float32) for k, s in shapes.items()}
    model = ckpt.perceiver_from_jax_numpy(
        ckpt.convert_perceiver(sd, cfg, miche_cli.PERCEIVER_PREFIX), cfg)
    pts = miche_cli.load_surface(surface, CLI_POINTS, 0)
    pts[:, 2] *= -1
    with torch.no_grad():
        lat = per.encode_latents(model, cfg, torch.from_numpy(pts)[None])
        dec = per.decode_latents(model, cfg, per.encode_kl_mode(model, lat[:, 1:]))
        xyz = recon.grid(1.1, CLI_DEPTH)[0]
        out = miche_cli.PERCEIVER_PREFIX + "geo_decoder.output_proj."
        # the logits are linear in the output projection: scale it to unit spread,
        # then move the level into a clear gap
        field = recon.occupancy_logits(model, cfg, dec, xyz) - sd[out + "bias"]
        sd[out + "weight"] = sd[out + "weight"] / np.float32(field.std())
        sd[out + "bias"] = -np.float32([clear_level(field / field.std())])
    weights = str(tmp / "perceiver.safetensors")
    save_file(sd, weights)
    return surface, weights


def _run_both(tmp_path, monkeypatch, weights, args, out_ours, out_ref):
    """Both CLIs with the small perceiver config (each builds its config
    inside main) and JAX's compile cache in the test's directory."""
    monkeypatch.setenv("MESHANYTHING_COMPILE_CACHE", str(tmp_path / "xla"))
    real = jconfig.MeshAnythingConfig
    monkeypatch.setattr(jconfig, "MeshAnythingConfig",
                        lambda: real(perceiver=JPerceiverConfig(**PER)))
    monkeypatch.setattr(config, "PerceiverConfig", lambda: PerceiverConfig(**PER))
    common = [*args, "--pretrained_weights", weights, "--num_points", str(CLI_POINTS)]
    record = miche_cli.main([*common, "--out", out_ours, "--device", "cpu"])
    jmiche.main([*common, "--out", out_ref])
    return record


@pytest.mark.parametrize("flip", ["--flip_z", "--no-flip_z"])
def test_miche_cli_encode_only_matches_jax(cli_files, tmp_path, monkeypatch, flip):
    surface, weights = cli_files
    ours, ref = str(tmp_path / "ours.npy"), str(tmp_path / "ref.npy")
    record = _run_both(tmp_path, monkeypatch, weights,
                       ["--input", surface, "--encode-only", flip], ours, ref)
    assert record["latents_shape"] == [1, PER["num_latents"], PER["embed_dim"]]
    np.testing.assert_allclose(np.load(ours), np.load(ref), atol=LATENT_ATOL, rtol=LATENT_ATOL)


def test_miche_cli_reconstruction_matches_jax(cli_files, tmp_path, monkeypatch):
    surface, weights = cli_files
    ours, ref = str(tmp_path / "ours.obj"), str(tmp_path / "ref.obj")
    record = _run_both(tmp_path, monkeypatch, weights,
                       ["--input", surface, "--octree_depth", str(CLI_DEPTH)], ours, ref)
    a, b = load_obj(ours), load_obj(ref)
    assert record["faces"] == len(a.faces) > 0
    assert record["queries"] == (2 ** CLI_DEPTH + 1) ** 3
    assert len(a.faces) == len(b.faces)
    np.testing.assert_allclose(a.vertices, b.vertices, atol=MESH_ATOL)


def test_miche_cli_random_weights_and_no_card(tmp_path):
    surface = sphere_surface(str(tmp_path / "s.npz"))
    argv = ["--input", surface, "--random_weights", "--encode-only", "--out",
            str(tmp_path / "z.npy"), "--num_points", str(CLI_POINTS)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            miche_cli.main(argv)              # --device cuda is the default
    assert miche_cli.get_args(argv).device == "cuda"
    args = miche_cli.get_args([*argv, "--device", "cpu"])
    cfg = PerceiverConfig(**PER)
    model = miche_cli.load_perceiver(args, cfg, torch.device("cpu"))
    again = miche_cli.load_perceiver(args, cfg, torch.device("cpu"))
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters()))
    record = miche_cli.run(args, model, cfg)
    assert np.load(record["out"]).shape == (1, PER["num_latents"], PER["embed_dim"])
    with pytest.raises(FileNotFoundError, match="random_weights"):
        miche_cli.load_perceiver(miche_cli.get_args(
            ["--input", surface, "--out", "x", "--pretrained_weights",
             str(tmp_path / "missing.pth")]), cfg, torch.device("cpu"))


def test_load_surface_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    cloud = rng.normal(size=(500, 6)).astype(np.float32)
    np.save(tmp_path / "c.npy", cloud)
    np.savez(tmp_path / "s.npz", surface=cloud)
    for path in (str(tmp_path / "c.npy"), str(tmp_path / "s.npz")):
        np.testing.assert_array_equal(miche_cli.load_surface(path, 128, 5),
                                      jmiche.load_surface(path, 128, 5))
    with pytest.raises(ValueError, match="at least"):
        miche_cli.load_surface(str(tmp_path / "c.npy"), 1000)
    np.savez(tmp_path / "bad.npz", other=cloud)
    with pytest.raises(ValueError, match="keys"):
        miche_cli.load_surface(str(tmp_path / "bad.npz"))
