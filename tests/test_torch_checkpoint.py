"""The reference checkpoint and the port's own checkpoints
(``meshanything_tpu_torch/runtime/checkpoint.py``), held to the JAX
package's converter: the safetensors reader against the ``safetensors``
package, a seeded state dict under the reference's key names (built from
the config's shapes alone) converted by both walks, bridged into
parameters that must be bit-equal, and decoded into the same greedy
tokens; unread keys named, missing keys raised; the native checkpoint's
round trip."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors import safe_open
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch_file

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.runtime import checkpoint as jckpt
from meshanything_tpu.runtime.phases import PhaseRunner as JaxPhaseRunner
from meshanything_tpu_torch import cli
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.runtime import checkpoint as ckpt
from meshanything_tpu_torch.runtime.phases import PhaseRunner


EXTRA_KEY = "transformer.model.decoder.embed_tokens.weight"   # in the shipped file, never read


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread in each test, as the other port tests pin it
    (the test command runs several workers at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def seeded_state_dict(cfg, seed: int = 0, *, fused_nrd: bool = True,
                      extra: bool = False) -> dict:
    """f32 values under the reference's key names, from the shapes alone
    (small, so that the decode stays in range)."""
    rng = np.random.default_rng(seed)
    shapes = ckpt.reference_key_shapes(cfg, fused_nrd=fused_nrd)
    if extra:
        shapes[EXTRA_KEY] = (cfg.opt.vocab_size, cfg.opt.hidden_size)
    return {k: (rng.normal(size=s) * 0.05).astype(np.float32) for k, s in shapes.items()}


def write_checkpoint(path, sd: dict) -> str:
    save_file(sd, str(path))
    return str(path)


def params_of(model) -> dict:
    return {n: p.detach() for n, p in model.named_parameters()}


def assert_bit_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


# ---------------------------------------------------------------------------
# the reader


NP_CASES = {
    "F32": np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32),
    "F16": np.random.default_rng(2).normal(size=(7,)).astype(np.float16),
    "I64": np.arange(-6, 6, dtype=np.int64).reshape(3, 4),
    "I32": np.arange(10, dtype=np.int32)[::-1].copy(),
    "0-d": np.array(2.5, np.float32),
    "empty": np.zeros((0, 4), np.float32),
}


@pytest.mark.parametrize("case", sorted(NP_CASES))
def test_reader_matches_the_safetensors_package(tmp_path, case):
    """Each supported numpy dtype, 0-d and empty tensors: the same arrays
    as ``safe_open``, beside other tensors in one file (offsets past 0)."""
    tensors = {"before": np.ones((2, 3), np.float32), "x": NP_CASES[case],
               "after": np.arange(5, dtype=np.int64)}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"note": case})
    mine = ckpt.load_safetensors(path)
    assert mine.metadata == {"note": case}
    with safe_open(path, framework="np") as ref:
        assert sorted(mine) == sorted(ref.keys())
        for key in ref.keys():
            want, got = ref.get_tensor(key), mine[key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(6, 5), (), (0,)])
def test_reader_widens_bf16_exactly(tmp_path, shape):
    """BF16 is read as f32 whose bits are the bf16 bits shifted up: equal,
    bit for bit, to torch's widening of the same tensor."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(shape, generator=gen) * 100).bfloat16()
    path = str(tmp_path / "b.safetensors")
    save_torch_file({"x": x, "y": torch.ones(3)}, path)
    got = ckpt.load_safetensors(path)["x"]
    assert got.dtype == np.float32 and got.shape == tuple(shape)
    np.testing.assert_array_equal(got.view(np.uint32), x.float().numpy().view(np.uint32))


def _raw_file(path, header: dict, data: bytes) -> str:
    import json

    head = json.dumps(header).encode()
    with open(path, "wb") as fh:
        fh.write(len(head).to_bytes(8, "little") + head + data)
    return str(path)


@pytest.mark.parametrize("fault,message", [
    ("no_header", "truncated"),
    ("short_header", "truncated"),
    ("short_data", "truncated"),
    ("overlap", "overlap"),
    ("negative", "data_offsets"),
    ("size", "needs 12 bytes"),
    ("dtype", "does not know"),
])
def test_reader_refuses_broken_files(tmp_path, fault, message):
    path = tmp_path / "bad.safetensors"
    good = {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]},
            "b": {"dtype": "F32", "shape": [2], "data_offsets": [16, 24]}}
    data = bytes(24)
    if fault == "no_header":
        path.write_bytes(b"\x05\x00")
    elif fault == "short_header":
        _raw_file(path, good, data)
        path.write_bytes(path.read_bytes()[:20])
    elif fault == "short_data":
        _raw_file(path, good, data[:20])
    elif fault == "overlap":
        _raw_file(path, {**good, "b": {"dtype": "F32", "shape": [2],
                                       "data_offsets": [8, 16]}}, data)
    elif fault == "negative":
        _raw_file(path, {**good, "b": {"dtype": "F32", "shape": [0],
                                       "data_offsets": [20, 16]}}, data)
    elif fault == "size":
        _raw_file(path, {**good, "a": {"dtype": "F32", "shape": [3],
                                       "data_offsets": [0, 16]}}, data)
    else:
        _raw_file(path, {**good, "a": {"dtype": "F8_E4M3", "shape": [16],
                                       "data_offsets": [0, 16]}}, data)
    with pytest.raises(ValueError, match=message):
        ckpt.load_safetensors(str(path))


# ---------------------------------------------------------------------------
# the conversion walk against JAX's


def _leaves(tree) -> list:
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("fused_nrd", [True, False], ids=["bettertransformer", "hf"])
def test_reference_file_loads_bit_equal_to_jax(tmp_path, fused_nrd):
    """A seeded file under the reference's key names, in both NRD namings:
    the port's numpy tree equals JAX's ``convert_meshanything`` leaf by
    leaf, every key the shapes name is read by JAX's walk, and the loaded
    parameters are bit-equal to JAX's tree bridged by
    ``params_from_jax_numpy``."""
    cfg, jcfg = small_test_config(), jax_small_config()
    sd = seeded_state_dict(cfg, 4, fused_nrd=fused_nrd)
    path = write_checkpoint(tmp_path / "MeshAnything_350m.pth", sd)

    read = ckpt._ReadKeys(sd)
    jtree = jckpt.convert_meshanything(read, jcfg)
    assert read.read == set(sd)          # the shapes name no key JAX does not read

    tree, unread = ckpt.read_reference_checkpoint(path, cfg)
    assert unread == []
    mine, theirs = _leaves(tree), _leaves(jtree)
    assert [k for k, _ in mine] == [k for k, _ in theirs]
    for (key, a), (_, b) in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)

    model = ckpt.load_reference_checkpoint(path, cfg)
    bridged = ckpt.params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jtree), cfg)
    assert_bit_equal(params_of(model), params_of(bridged))


def test_loading_in_bf16_casts_as_jax_does(tmp_path):
    """``dtype=torch.bfloat16``: every parameter is JAX's
    ``to_device_tree(tree, bfloat16)`` leaf, bit for bit."""
    cfg, jcfg = small_test_config(), jax_small_config()
    sd = seeded_state_dict(cfg, 5)
    path = write_checkpoint(tmp_path / "w.pth", sd)
    model = ckpt.load_reference_checkpoint(path, cfg, dtype=torch.bfloat16)
    jtree = jckpt.to_device_tree(jckpt.convert_meshanything(sd, jcfg), jnp.bfloat16)
    f32 = ckpt.params_from_jax_numpy(
        jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)), jtree), cfg)
    got = params_of(model)
    assert {p.dtype for p in got.values()} == {torch.bfloat16}
    # bf16 -> f32 is exact, so equal f32 values are equal bf16 bits
    assert_bit_equal({k: v.float() for k, v in got.items()}, params_of(f32))


def test_unread_key_is_named_not_refused(tmp_path, capfd):
    """The shipped file's unused ``embed_tokens`` loads in both packages;
    the port names it (once, on stderr) and loads the same parameters."""
    cfg, jcfg = small_test_config(), jax_small_config()
    sd = seeded_state_dict(cfg, 6, extra=True)
    path = write_checkpoint(tmp_path / "w.pth", sd)
    jckpt.convert_meshanything(sd, jcfg)            # JAX ignores it
    _, unread = ckpt.read_reference_checkpoint(path, cfg)
    assert unread == [EXTRA_KEY]
    model = ckpt.load_reference_checkpoint(path, cfg)
    err = capfd.readouterr().err
    assert err.count(EXTRA_KEY) == 1 and "not read" in err
    del sd[EXTRA_KEY]
    plain = ckpt.load_reference_checkpoint(write_checkpoint(tmp_path / "p.pth", sd), cfg)
    assert_bit_equal(params_of(model), params_of(plain))


@pytest.mark.parametrize("key", [
    "transformer.model.decoder.layers.1.fc2.weight",
    "point_encoder.model.shape_model.encoder.query",
    "tokenizer.decoder.layer.0.in_proj_bias",
    "cond_proj.weight",
])
def test_missing_key_raises_keyerror_in_both(tmp_path, key):
    cfg, jcfg = small_test_config(), jax_small_config()
    sd = seeded_state_dict(cfg, 7)
    del sd[key]
    with pytest.raises(KeyError, match=key):
        jckpt.convert_meshanything(sd, jcfg)
    with pytest.raises(KeyError, match=key):
        ckpt.load_reference_checkpoint(write_checkpoint(tmp_path / "w.pth", sd), cfg)


@pytest.mark.parametrize("lookahead", [0, 4])
def test_loaded_model_decodes_the_jax_tokens(tmp_path, lookahead):
    """The f32 greedy stream of the loaded port model equals JAX's
    ``attn="pallas"`` (interpret mode) on ``to_device_tree(
    convert_meshanything(sd))``, single-token and lookahead."""
    cfg, jcfg = small_test_config(n_max_triangles=4), jax_small_config(n_max_triangles=4)
    sd = seeded_state_dict(cfg, 8)
    model = ckpt.load_reference_checkpoint(write_checkpoint(tmp_path / "w.pth", sd), cfg)
    params = jckpt.to_device_tree(jckpt.convert_meshanything(sd, jcfg))
    pc = np.random.default_rng(9).normal(size=(2, cfg.perceiver.num_points, 6)).astype(np.float32)
    pc[..., :3] *= 0.3
    pc[..., 3:] /= np.linalg.norm(pc[..., 3:], axis=-1, keepdims=True)
    want = JaxPhaseRunner(params, jcfg, bucket=16, attn="pallas", lookahead=lookahead)(
        jnp.asarray(pc)).token_ids
    got = PhaseRunner(model, cfg, bucket=16, lookahead=lookahead)(pc).token_ids
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 1:] != cfg.opt.eos_token_id).any()    # a stream, not eos at once


# ---------------------------------------------------------------------------
# the port's own checkpoints


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_native_round_trip_is_bit_equal(tmp_path, dtype):
    cfg = small_test_config()
    model = ckpt.init_random_params(cfg, torch.Generator().manual_seed(1), dtype)
    ckpt.save_native(model, str(tmp_path / "ck"))
    back = ckpt.load_native(str(tmp_path / "ck"), cfg)
    assert_bit_equal(params_of(back), params_of(model))
    wider = ckpt.load_native(str(tmp_path / "ck"), cfg, dtype=torch.float32)
    assert_bit_equal(params_of(wider), {k: v.float() for k, v in params_of(model).items()})


def test_native_checkpoint_matches_by_name(tmp_path):
    """A parameter missing, one unknown, or a shape that differs raises."""
    cfg = small_test_config()
    model = ckpt.init_random_params(cfg, torch.Generator().manual_seed(2), torch.float32)
    path = ckpt.save_native(model, str(tmp_path / "ck"))
    saved = torch.load(path, weights_only=True)
    for change, message in ((lambda d: d.pop("opt.lm_head.weight"), "missing"),
                            (lambda d: d.__setitem__("opt.extra", torch.zeros(1)), "unknown"),
                            (lambda d: d.__setitem__("cond_proj.bias", torch.zeros(3)), "shape")):
        broken = dict(saved)
        change(broken)
        torch.save(broken, path)
        with pytest.raises(ValueError, match=message):
            ckpt.load_native(str(tmp_path / "ck"), cfg)


def test_cli_loads_the_file_and_the_native_dir_alike(tmp_path, monkeypatch, capsys):
    """``--pretrained_weights <file>`` without ``--random_weights`` converts
    the reference file (and says so); the model saved as a native
    checkpoint and loaded through ``--pretrained_weights <dir>`` writes
    the same OBJ bytes, and both equal JAX's pipeline on the same file."""
    from meshanything_tpu.runtime.pipeline import InferencePipeline as JaxPipeline
    from meshanything_tpu.runtime.pipeline import load_inputs as jax_load_inputs

    cfg, jcfg = small_test_config(n_max_triangles=4), jax_small_config(n_max_triangles=4)
    sd = seeded_state_dict(cfg, 10)
    path = write_checkpoint(tmp_path / "MeshAnything_350m.pth", sd)
    npy = tmp_path / "ellipsoid.npy"
    pc = np.random.default_rng(11).normal(size=(200, 6)).astype(np.float32) * 0.3
    pc[:, 3:] /= np.linalg.norm(pc[:, 3:], axis=-1, keepdims=True)
    np.save(npy, pc)
    monkeypatch.setattr(cli, "build_config", lambda args: cfg)
    common = ["--input_path", str(npy), "--input_type", "pc_normal", "--device", "cpu",
              "--dtype", "float32", "--bucket", "16", "--seed", "0"]
    from_file = cli.main([*common, "--pretrained_weights", path, "--out_dir",
                          str(tmp_path / "file")])
    assert f"converted reference checkpoint: {path}" in capsys.readouterr().out

    args = cli.get_args([*common, "--pretrained_weights", path])
    ckpt.save_native(cli.load_params(args, cfg, torch.device("cpu")), str(tmp_path / "native"))
    from_dir = cli.main([*common, "--pretrained_weights", str(tmp_path / "native"),
                         "--out_dir", str(tmp_path / "dir")])

    jpipe = JaxPipeline(jckpt.to_device_tree(jckpt.convert_meshanything(sd, jcfg)), jcfg,
                        batch_size=1, bucket=16, attn="pallas")
    jres = jpipe.run(jax_load_inputs("pc_normal", [str(npy)], num_points=64, seed=0),
                     str(tmp_path / "jax"), seed=0)
    objs = [open(r[0]["obj_path"], "rb").read() for r in (from_file, from_dir, jres)]
    assert from_file[0]["faces_generated"] == jres[0]["faces_generated"] > 0
    assert objs[0] == objs[1] == objs[2]
    assert os.path.basename(from_dir[0]["obj_path"]) == "ellipsoid_gen.obj"
