"""Host stage, CLI and packaging of the PyTorch port: the JAX-free
geometry copies behave byte for byte like the JAX package's, the CLI
writes the same OBJ bytes as the JAX pipeline on the same weights, the
port imports without JAX, and the weight bridge consumes every leaf."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from meshanything_tpu import geometry as jgeo
from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.geometry import postprocess as jpost
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.runtime.pipeline import InferencePipeline as JaxPipeline
from meshanything_tpu.runtime.pipeline import load_inputs as jax_load_inputs
from meshanything_tpu_torch import cli
from meshanything_tpu_torch import geometry as geo
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.geometry import postprocess as post
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy
from meshanything_tpu_torch.runtime.pipeline import load_inputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cube():
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float64)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]],
                 dtype=np.int64)
    return v, f


def _point_cloud(rng, n):
    pc = rng.normal(size=(n, 6)) * 0.3
    pc[:, 3:] /= np.linalg.norm(pc[:, 3:], axis=-1, keepdims=True)
    return pc.astype(np.float32)


def test_obj_and_ply_io_match_jax(tmp_path):
    v, f = _cube()
    a, b = str(tmp_path / "a.obj"), str(tmp_path / "b.obj")
    jgeo.save_obj(jgeo.Mesh(v, f), a)
    geo.save_obj(geo.Mesh(v, f), b)
    assert open(a, "rb").read() == open(b, "rb").read()
    ply = tmp_path / "cube.ply"
    header = ("ply\nformat ascii 1.0\nelement vertex 8\nproperty float x\nproperty float y\n"
              "property float z\nelement face 6\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    quads = ["4 0 3 2 1", "4 4 5 6 7", "4 0 1 5 4", "4 2 3 7 6", "4 1 2 6 5", "4 3 0 4 7"]
    ply.write_text(header + "".join(f"{x} {y} {z}\n" for x, y, z in v) + "\n".join(quads) + "\n")
    for path in (a, str(ply)):
        mine, ref = geo.load_mesh(path), jgeo.load_mesh(path)
        np.testing.assert_array_equal(mine.vertices, ref.vertices)
        np.testing.assert_array_equal(mine.faces, ref.faces)
    with pytest.raises(ValueError, match="unsupported mesh format"):
        geo.load_mesh(str(tmp_path / "cube.xyz"))


def test_sampling_and_normalization_match_jax():
    v, f = _cube()
    mine = geo.sample_surface_with_normals(v, f, 500, np.random.default_rng(3))
    ref = jgeo.sample_surface_with_normals(v, f, 500, np.random.default_rng(3))
    np.testing.assert_array_equal(mine, ref)
    pc = _point_cloud(np.random.default_rng(4), 300)
    np.testing.assert_array_equal(geo.normalize_pc_cli(pc), jgeo.normalize_pc_cli(pc))
    bad = pc.copy()
    bad[0, 3:] = 0.0
    with pytest.raises(ValueError, match="unit vectors"):
        geo.normalize_pc_cli(bad)


def test_postprocess_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    coords = rng.integers(-64, 64, size=(40, 3, 3)) / 128.0
    coords[5:9] = coords[:4]                     # duplicate faces
    coords[10, 1] = coords[10, 0]                # a degenerate face
    coords[30:] = np.nan                         # unfilled slots
    v, f = np.asarray(coords[:30]).reshape(-1, 3), np.arange(90).reshape(-1, 3)
    mv, mf = post.merge_vertices(v, f)
    rv, rf = jpost.merge_vertices(v, f)
    np.testing.assert_array_equal(mv, rv)
    np.testing.assert_array_equal(mf, rf)
    faces = post.remove_degenerate_and_duplicate_faces(mf)
    np.testing.assert_array_equal(faces, jpost.remove_degenerate_and_duplicate_faces(rf))
    np.testing.assert_array_equal(post.fix_normals(mv, faces), jpost.fix_normals(rv, faces))
    a, b = str(tmp_path / "a.obj"), str(tmp_path / "b.obj")
    post.postprocess_faces(coords, a)
    jpost.postprocess_faces(coords, b)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_load_inputs_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    npy = tmp_path / "pc.npy"
    np.save(npy, _point_cloud(rng, 200))
    v, f = _cube()
    obj = str(tmp_path / "cube.obj")
    geo.save_obj(geo.Mesh(v, f), obj)
    for kind, path in (("pc_normal", str(npy)), ("mesh", obj)):
        mine = load_inputs(kind, [path], num_points=64, seed=2)
        ref = jax_load_inputs(kind, [path], num_points=64, seed=2)
        assert mine[0].uid == ref[0].uid
        np.testing.assert_array_equal(mine[0].pc_normal, ref[0].pc_normal)


def test_cli_writes_the_jax_pipelines_obj_bytes(tmp_path, monkeypatch):
    """``python -m meshanything_tpu_torch.cli --device cpu`` against the
    JAX InferencePipeline with attn="pallas" (its default resolves to
    "xla" on the CPU), on the same bridged weights and input file."""
    jcfg = jax_small_config(n_max_triangles=4)
    cfg = small_test_config(n_max_triangles=4)
    params = jma.init_meshanything_params(jax.random.PRNGKey(42), jcfg)
    tree = jax.tree_util.tree_map(np.array, params)
    npy = tmp_path / "mouse.npy"
    np.save(npy, _point_cloud(np.random.default_rng(8), 200))

    jdir = tmp_path / "jax"
    jpipe = JaxPipeline(params, jcfg, batch_size=1, bucket=16, attn="pallas")
    jres = jpipe.run(jax_load_inputs("pc_normal", [str(npy)], num_points=64, seed=0),
                     str(jdir), seed=0)

    monkeypatch.setattr(cli, "build_config", lambda args: cfg)
    monkeypatch.setattr(cli, "load_params",
                        lambda args, cfg_, device: params_from_jax_numpy(tree, cfg_, device=device))
    res = cli.main(["--input_path", str(npy), "--input_type", "pc_normal", "--out_dir",
                    str(tmp_path / "port"), "--device", "cpu", "--random_weights",
                    "--dtype", "float32", "--bucket", "16", "--seed", "0"])
    assert len(res) == 1 and res[0]["faces_generated"] == jres[0]["faces_generated"] > 0
    assert os.path.dirname(os.path.dirname(res[0]["obj_path"])) == str(tmp_path / "port")
    assert os.path.basename(res[0]["obj_path"]) == "mouse_gen.obj"
    assert res[0]["decode_steps"] == cfg.generate_length - 1
    assert open(res[0]["obj_path"], "rb").read() == open(jres[0]["obj_path"], "rb").read()


@pytest.mark.parametrize("flags", [["--attn", "xla"],
                                   ["--fast", "--attn", "xla"],
                                   ["--complete_from", "p.obj", "--attn", "xla"]])
def test_cli_refuses_what_is_not_ported(flags):
    args = cli.get_args(["--input_path", "x.npy", "--input_type", "pc_normal", *flags,
                         "--random_weights"])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.check_ported(args)


@pytest.mark.parametrize("flags", [["--mc", "--pretrained_weights", "w.pth"],
                                   ["--pretrained_weights", "w.pth"], []])
def test_cli_missing_checkpoint_raises_jax_message(tmp_path, monkeypatch, flags):
    """Without ``--random_weights`` the checkpoint is loaded: a missing
    ``--pretrained_weights`` (or the default ``MeshAnything_350m.pth``)
    raises JAX's ``FileNotFoundError``, word for word."""
    from meshanything_tpu.cli import get_args as jax_get_args
    from meshanything_tpu.cli import load_params as jax_load_params

    monkeypatch.chdir(tmp_path)
    argv = ["--input_path", "x.npy", "--input_type", "pc_normal", *flags]
    args = cli.get_args(argv)
    cli.check_ported(args)
    with pytest.raises(FileNotFoundError) as mine:
        cli.load_params(args, small_test_config(), torch.device("cpu"))
    with pytest.raises(FileNotFoundError) as theirs:
        jax_load_params(jax_get_args(argv), jax_small_config())
    assert str(mine.value) == str(theirs.value)
    assert repr(args.pretrained_weights) in str(mine.value)


def test_cli_refuses_attn_megakernel_as_jax_does(capsys):
    """``--attn megakernel`` is no choice of the JAX CLI's argparse, and
    none of the port's: InferencePipeline(attn="megakernel") is the entry."""
    from meshanything_tpu.cli import get_args as jax_get_args

    argv = ["--input_path", "x.npy", "--random_weights", "--attn", "megakernel"]
    for get_args in (cli.get_args, jax_get_args):
        with pytest.raises(SystemExit) as exc:
            get_args(argv)
        assert exc.value.code == 2
        assert "invalid choice: 'megakernel'" in capsys.readouterr().err


@pytest.mark.parametrize("flags,attn,lookahead,wq", [
    (["--fast"], "pallas_int8", 8, True),
    (["--fast", "--attn", "pallas_int4"], "pallas_int4", 8, True),
    (["--fast", "--lookahead", "adaptive"], "pallas_int8", "adaptive", True),
    (["--attn", "pallas_int4", "--lookahead", "4"], "pallas_int4", 4, False),
])
def test_cli_fast_preset_resolves_like_jax(flags, attn, lookahead, wq):
    """--fast means --wq --attn pallas_int8 --lookahead 8, and an explicit
    --attn/--lookahead wins over it (JAX cli.py::apply_fast_preset)."""
    from meshanything_tpu.cli import get_args as jax_get_args

    args = cli.get_args(["--input_path", "x.npy", "--random_weights", *flags])
    cli.check_ported(args)
    assert (args.attn, args.lookahead, args.wq) == (attn, lookahead, wq)
    jargs = jax_get_args(["--input_path", "x.npy", "--random_weights", *flags])
    assert (jargs.attn, jargs.lookahead, jargs.wq) == (attn, lookahead, wq)


@pytest.mark.parametrize("flags,jax_kw", [
    (["--fast"], dict(attn="pallas_int8", lookahead=8, wq=True)),
    (["--attn", "pallas_int4", "--lookahead", "4"], dict(attn="pallas_int4", lookahead=4)),
])
def test_cli_fast_tier_writes_the_jax_pipelines_obj_bytes(tmp_path, monkeypatch, flags, jax_kw):
    """The fast tier through the port's CLI against the JAX
    InferencePipeline with the same attn/lookahead/wq, on the same bridged
    weights and input file."""
    jcfg = jax_small_config(n_max_triangles=4)
    cfg = small_test_config(n_max_triangles=4)
    params = jma.init_meshanything_params(jax.random.PRNGKey(42), jcfg)
    tree = jax.tree_util.tree_map(np.array, params)
    npy = tmp_path / "mouse.npy"
    np.save(npy, _point_cloud(np.random.default_rng(8), 200))

    jpipe = JaxPipeline(params, jcfg, batch_size=1, bucket=16, **jax_kw)
    jres = jpipe.run(jax_load_inputs("pc_normal", [str(npy)], num_points=64, seed=0),
                     str(tmp_path / "jax"), seed=0)

    monkeypatch.setattr(cli, "build_config", lambda args: cfg)
    monkeypatch.setattr(cli, "load_params",
                        lambda args, cfg_, device: params_from_jax_numpy(tree, cfg_, device=device))
    res = cli.main(["--input_path", str(npy), "--input_type", "pc_normal", "--out_dir",
                    str(tmp_path / "port"), "--device", "cpu", "--random_weights",
                    "--dtype", "float32", "--bucket", "16", "--seed", "0", *flags])
    assert len(res) == 1 and res[0]["faces_generated"] == jres[0]["faces_generated"] > 0
    assert 0 < res[0]["window_forwards"] < cfg.generate_length
    assert res[0]["mean_accept"] > 0
    assert open(res[0]["obj_path"], "rb").read() == open(jres[0]["obj_path"], "rb").read()


def test_cli_cuda_device_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.resolve_device("cuda")


def test_port_imports_without_jax():
    """Every module of the port (runtime/aot.py, compile_cache.py and
    checkpoint.py among them) and the root entries ``main_torch.py`` and
    ``app_torch.py`` import with JAX made unimportable, and nothing of the
    JAX package comes with them."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import meshanything_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, main_torch, app_torch\n"
        "bad = [k for k in sys.modules if k == 'meshanything_tpu' or k.startswith('meshanything_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result without CUDA,
    and in a directory holding nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bridge_consumes_every_leaf_and_rejects_mismatches():
    jcfg, cfg = jax_small_config(), small_test_config()
    tree = jax.tree_util.tree_map(np.array, jma.init_meshanything_params(jax.random.PRNGKey(0), jcfg))
    model = params_from_jax_numpy(tree, cfg)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    # stacked leaves become one parameter per layer
    assert sum(1 for _ in model.parameters()) >= n_leaves
    np.testing.assert_array_equal(model.opt.layers[1].fc1.weight.detach().numpy(),
                                  tree["opt"]["layers"]["fc1"]["w"][1].T)
    extra = jax.tree_util.tree_map(np.array, tree)
    extra["opt"]["unused"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="not consumed"):
        params_from_jax_numpy(extra, cfg)
    missing = jax.tree_util.tree_map(np.array, tree)
    del missing["nrd"]["layernorm"]["bias"]
    with pytest.raises(KeyError, match="nrd/layernorm/bias"):
        params_from_jax_numpy(missing, cfg)
    wrong = jax.tree_util.tree_map(np.array, tree)
    wrong["opt"]["layers"]["qkv"]["w"] = wrong["opt"]["layers"]["qkv"]["w"][:1]
    with pytest.raises(ValueError, match="stacked layer counts"):
        params_from_jax_numpy(wrong, cfg)
