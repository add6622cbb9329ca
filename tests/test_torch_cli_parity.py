"""The port's CLI flags and the pipeline's failure handling against the
JAX package's: the reference flags reach the config as JAX's
``build_config`` sets them, and a batch whose generation raises is retried
and then recorded as ``{"uid", "error"}`` as JAX's ``InferencePipeline.run``
records it; ``collect_inputs``, ``--precompile`` without input,
``--resume``, ``export`` and ``--metrics_out`` as JAX's."""
import os

import numpy as np
import pytest

import jax

from meshanything_tpu.cli import build_config as jax_build_config
from meshanything_tpu.cli import get_args as jax_get_args
from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.runtime.pipeline import InferencePipeline as JaxPipeline
from meshanything_tpu.runtime.pipeline import load_inputs as jax_load_inputs
from meshanything_tpu_torch import cli
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy
from meshanything_tpu_torch.runtime.pipeline import InferencePipeline, load_inputs


@pytest.mark.parametrize("flags", [
    [],
    ["--llm", "facebook/opt-125m"],
    ["--codebook_size", "64", "--codebook_dim", "32"],
    ["--codebook_size", "4096", "--n_max_triangles", "100", "--dtype", "float32"],
])
def test_reference_flags_reach_the_config_as_in_jax(flags):
    """--llm is accepted and recorded; --codebook_size/--codebook_dim set
    the codebook and vocab_size = codebook_size + 3 (JAX cli.py:101-112)."""
    argv = ["--input_path", "x.npy", "--random_weights", *flags]
    args, jargs = cli.get_args(argv), jax_get_args(argv)
    assert (args.llm, args.codebook_size, args.codebook_dim) == (
        jargs.llm, jargs.codebook_size, jargs.codebook_dim)
    cfg, jcfg = cli.build_config(args), jax_build_config(jargs)
    for name in ("codebook_size", "codebook_dim", "vocab_size", "hidden_size", "num_layers"):
        assert getattr(cfg.opt, name) == getattr(jcfg.opt, name), name
    assert (cfg.n_max_triangles, cfg.dtype) == (jcfg.n_max_triangles, jcfg.dtype)
    cli.check_ported(args)   # none of them is refused


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """The JAX and the port's pipeline on the same bridged small weights,
    and two seeded point clouds loaded by each."""
    tmp = tmp_path_factory.mktemp("inputs")
    jcfg, cfg = jax_small_config(n_max_triangles=4), small_test_config(n_max_triangles=4)
    params = jma.init_meshanything_params(jax.random.PRNGKey(42), jcfg)
    model = params_from_jax_numpy(jax.tree_util.tree_map(np.array, params), cfg)
    rng = np.random.default_rng(8)
    paths = []
    for name in ("a", "b"):
        pc = rng.normal(size=(200, 6)) * 0.3
        pc[:, 3:] /= np.linalg.norm(pc[:, 3:], axis=-1, keepdims=True)
        paths.append(str(tmp / f"{name}.npy"))
        np.save(paths[-1], pc.astype(np.float32))
    return (JaxPipeline(params, jcfg, batch_size=2, bucket=16, attn="pallas"),
            jax_load_inputs("pc_normal", paths, num_points=64, seed=0),
            InferencePipeline(model, cfg, batch_size=2, bucket=16),
            load_inputs("pc_normal", paths, num_points=64, seed=0))


@pytest.mark.parametrize("max_retries", [0, 1, 2])
def test_failed_batch_is_retried_then_recorded_as_in_jax(pipelines, tmp_path, monkeypatch,
                                                         max_retries):
    """A generation that always raises: each pipeline calls it
    max_retries + 1 times for the batch and records one {"uid", "error":
    "<Type>: <message>"} a mesh, the same records."""
    jpipe, jsamples, pipe, samples = pipelines
    calls = {"jax": 0, "port": 0}

    def failing(which):
        def run(*args, **kwargs):
            calls[which] += 1
            raise RuntimeError("device fault")
        return run

    monkeypatch.setattr(jpipe, "_gen_greedy", failing("jax"))
    monkeypatch.setattr(pipe, "generate", failing("port"))
    want = jpipe.run(jsamples, str(tmp_path / "jax"), seed=0, max_retries=max_retries)
    got = pipe.run(samples, str(tmp_path / "port"), seed=0, max_retries=max_retries)
    assert got == want == [{"uid": "a", "error": "RuntimeError: device fault"},
                           {"uid": "b", "error": "RuntimeError: device fault"}]
    assert calls == {"jax": max_retries + 1, "port": max_retries + 1}


def test_a_retry_that_succeeds_gives_the_normal_records(pipelines, tmp_path, monkeypatch):
    """One failure, then the real generation: no error record, and the
    meshes of a run without the failure."""
    _, _, pipe, samples = pipelines
    clean = pipe.run(samples, str(tmp_path / "clean"), seed=0)
    real, failures = pipe.generate, []

    def flaky(*args, **kwargs):
        if not failures:
            failures.append(1)
            raise RuntimeError("transient")
        return real(*args, **kwargs)

    monkeypatch.setattr(pipe, "generate", flaky)
    got = pipe.run(samples, str(tmp_path / "retried"), seed=0, max_retries=1)
    assert failures == [1] and not any("error" in r for r in got)
    assert [r["faces_generated"] for r in got] == [r["faces_generated"] for r in clean]
    for a, b in zip(got, clean):
        assert open(a["obj_path"], "rb").read() == open(b["obj_path"], "rb").read()


@pytest.mark.parametrize("kind", ["mc", "complete_from"])
def test_mc_and_complete_from_write_the_jax_clis_obj_bytes(tmp_path, monkeypatch, kind):
    """``--mc`` (a mesh input watertighted through the distance field and
    marching tetrahedra) and ``--complete_from`` (a partial mesh's faces
    seeding the decoder) through the port's CLI and through the JAX CLI,
    both with ``--attn pallas``, on the same bridged weights: the same OBJ
    bytes. The JAX CLI's persistent compile cache is left off."""
    import meshanything_tpu.cli as jax_cli
    import meshanything_tpu.runtime.compile_cache as jax_compile_cache
    from meshanything_tpu_torch.geometry import Mesh, save_obj

    jcfg, cfg = jax_small_config(n_max_triangles=4), small_test_config(n_max_triangles=4)
    params = jma.init_meshanything_params(jax.random.PRNGKey(42), jcfg)
    tree = jax.tree_util.tree_map(np.array, params)
    if kind == "mc":
        path = str(tmp_path / "tet.obj")
        save_obj(Mesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float),
                      np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]])), path)
        flags = ["--input_type", "mesh", "--input_path", path, "--mc"]
    else:
        rng = np.random.default_rng(8)
        pc = rng.normal(size=(200, 6)) * 0.3
        pc[:, 3:] /= np.linalg.norm(pc[:, 3:], axis=-1, keepdims=True)
        path = str(tmp_path / "mouse.npy")
        np.save(path, pc.astype(np.float32))
        partial = str(tmp_path / "partial.obj")
        save_obj(Mesh(rng.uniform(-0.45, 0.45, size=(5, 3)),
                      np.array([[0, 1, 2], [2, 3, 4]])), partial)
        flags = ["--input_type", "pc_normal", "--input_path", path, "--complete_from", partial]
    common = ["--random_weights", "--dtype", "float32", "--bucket", "16", "--seed", "0",
              "--attn", "pallas", *flags]

    monkeypatch.setattr(jax_compile_cache, "enable", lambda *a, **k: None)
    monkeypatch.setattr(jax_cli, "build_config", lambda args: jcfg)
    monkeypatch.setattr(jax_cli, "load_params", lambda args, cfg_: params)
    jres = jax_cli.main(["--out_dir", str(tmp_path / "jax"), *common])
    monkeypatch.setattr(cli, "build_config", lambda args: cfg)
    monkeypatch.setattr(cli, "load_params",
                        lambda args, cfg_, device: params_from_jax_numpy(tree, cfg_, device=device))
    res = cli.main(["--out_dir", str(tmp_path / "port"), "--device", "cpu", *common])
    assert len(res) == len(jres) == 1 and "error" not in res[0]
    assert res[0]["faces_generated"] == jres[0]["faces_generated"] > 0
    assert open(res[0]["obj_path"], "rb").read() == open(jres[0]["obj_path"], "rb").read()
    if kind == "complete_from":
        assert res[0]["decode_steps"] == cfg.generate_length - 1 - (1 + 2 * 9)


@pytest.mark.parametrize("input_type", ["pc_normal", "mesh"])
def test_collect_inputs_filters_like_jax(tmp_path, input_type):
    """A mixed folder (tests/test_cli.py's): pc_normal takes the .npy
    files, mesh the .npy .obj .ply .stl .off .glb files, as JAX's
    ``collect_inputs``."""
    from meshanything_tpu.cli import collect_inputs as jax_collect_inputs

    for name in ("a.npy", "b.obj", "c.ply", "d.txt", "e.stl", "f.off", "g.glb"):
        (tmp_path / name).write_bytes(b"x")
    argv = ["--input_dir", str(tmp_path), "--input_type", input_type]
    mine = cli.collect_inputs(cli.get_args(argv))
    assert mine == jax_collect_inputs(jax_get_args(argv))
    assert [p.rsplit("/", 1)[1] for p in mine] == (
        ["a.npy"] if input_type == "pc_normal"
        else ["a.npy", "b.obj", "c.ply", "e.stl", "f.off", "g.glb"])


@pytest.mark.parametrize("precompile", [False, True])
def test_collect_inputs_without_input(precompile):
    """No input: an error, unless --precompile (build and capture only)."""
    from meshanything_tpu.cli import collect_inputs as jax_collect_inputs

    argv = ["--precompile"] if precompile else []
    if precompile:
        assert cli.collect_inputs(cli.get_args(argv)) == jax_collect_inputs(
            jax_get_args(argv)) == []
    else:
        for collect, args in ((cli.collect_inputs, cli.get_args(argv)),
                              (jax_collect_inputs, jax_get_args(argv))):
            with pytest.raises(ValueError, match="input_dir or input_path"):
                collect(args)


def test_precompile_without_input_returns_no_records(tmp_path, monkeypatch):
    """``--precompile`` with no input builds (nothing on the CPU) and
    returns [] before any generation."""
    cfg = small_test_config(n_max_triangles=4)
    monkeypatch.setattr(cli, "build_config", lambda args: cfg)
    assert cli.main(["--precompile", "--random_weights", "--device", "cpu", "--out_dir",
                     str(tmp_path)]) == []


JAX_RECORD_KEYS = ("uid", "faces_generated", "faces_final")


@pytest.mark.parametrize("export", [True, False])
def test_resume_and_metrics_match_jax(pipelines, tmp_path, export):
    """``run(resume=True)`` skips the sample whose OBJ exists and records it
    in ``timings`` as JAX's run does; the other sample's record holds
    JAX's fields with JAX's values and the same OBJ bytes;
    ``export=False`` writes none; ``write_metrics`` writes one JSON object
    a line."""
    import json

    from meshanything_tpu.runtime.pipeline import write_metrics as jax_write_metrics
    from meshanything_tpu_torch.runtime.pipeline import write_metrics

    jpipe, jsamples, pipe, samples = pipelines
    jpipe.timings, pipe.timings = [], []
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for which, (p, s) in {"jax": (jpipe, jsamples), "port": (pipe, samples)}.items():
        p.run(s, str(dirs[which]), seed=0)
        os.remove(dirs[which] / "b_gen.obj")
        p.timings = []
    jres = jpipe.run(jsamples, str(dirs["jax"]), seed=0, resume=True, export=export)
    res = pipe.run(samples, str(dirs["port"]), seed=0, resume=True, export=export)
    for t, d in ((jpipe.timings, dirs["jax"]), (pipe.timings, dirs["port"])):
        assert t[0] == {"uid": "a", "skipped": True, "obj_path": str(d / "a_gen.obj")}
    assert [r["uid"] for r in res] == [r["uid"] for r in jres] == ["b"]
    assert pipe.timings[1:] == res
    keys = JAX_RECORD_KEYS if export else JAX_RECORD_KEYS[:2]
    assert {k: res[0][k] for k in keys} == {k: jres[0][k] for k in keys}
    assert os.path.exists(dirs["port"] / "b_gen.obj") == export
    if export:
        assert (open(res[0]["obj_path"], "rb").read()
                == open(jres[0]["obj_path"], "rb").read())
    else:
        assert "obj_path" not in res[0] and "obj_path" not in jres[0]
    write_metrics(pipe.timings, str(tmp_path / "m.jsonl"))
    jax_write_metrics(jpipe.timings, str(tmp_path / "jm.jsonl"))
    lines = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    jlines = [json.loads(ln) for ln in open(tmp_path / "jm.jsonl")]
    assert lines == json.loads(json.dumps(pipe.timings)) and len(lines) == len(jlines) == 2
    assert set(jlines[1]) <= set(lines[1])


def test_cli_metrics_out_writes_the_records(tmp_path, monkeypatch):
    """``--metrics_out``: the CLI's records, one JSON object a line."""
    import json

    cfg = small_test_config(n_max_triangles=4)
    rng = np.random.default_rng(8)
    for name in ("a", "b"):
        pc = rng.normal(size=(200, 6)) * 0.3
        pc[:, 3:] /= np.linalg.norm(pc[:, 3:], axis=-1, keepdims=True)
        np.save(tmp_path / f"{name}.npy", pc.astype(np.float32))
    monkeypatch.setattr(cli, "build_config", lambda args: cfg)
    metrics = tmp_path / "metrics.jsonl"
    res = cli.main(["--input_dir", str(tmp_path), "--input_type", "pc_normal", "--random_weights",
                    "--device", "cpu", "--dtype", "float32", "--bucket", "16", "--out_dir",
                    str(tmp_path / "out"), "--metrics_out", str(metrics),
                    "--batchsize_per_gpu", "2"])
    assert [json.loads(ln) for ln in open(metrics)] == json.loads(json.dumps(res))
    assert [r["uid"] for r in res] == ["a", "b"]
