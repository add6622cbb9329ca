"""Warm start of the port: the kernel libraries' key and store
(``ops/_build.py``, ``runtime/aot.py``, ``runtime/compile_cache.py``),
``PhaseRunner.precompile``, the runner's options held to JAX's runner,
and the decode states the runner keeps across requests (on the CPU the
eager path refills them; on the card their graphs replay), with the
packaging of the kernel sources."""
import ast
import fnmatch
import glob
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.runtime.phases import PhaseRunner as JaxPhaseRunner
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.ops import _build
from meshanything_tpu_torch.runtime import aot, compile_cache, phases
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy
from meshanything_tpu_torch.runtime.phases import PhaseRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"capability": (9, 0), "nvcc": "Cuda compilation tools, release 12.4, V12.4.131",
         "torch_cuda": "12.4"}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread in each test, as the other port tests pin it
    (the test command runs several workers at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """No nvcc and no card here: the toolchain is fixed, a "build" writes
    the source's name into the library file, and "loading" a file that
    does not start with it raises as ctypes does. Returns the builds made."""
    builds = []

    def compile_(src, out):
        builds.append(os.path.basename(src))
        with open(out, "wb") as fh:
            fh.write(b"lib:" + os.path.basename(src).encode())
        return 0.5, "ptxas info: 0 bytes spill"

    def open_(path):
        with open(path, "rb") as fh:
            if not fh.read().startswith(b"lib:"):
                raise OSError(f"{path}: invalid ELF header")
        return object()

    monkeypatch.setattr(_build, "toolchain", lambda directory: dict(TOOLS))
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "_open", open_)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_stored", set())
    monkeypatch.setattr(_build, "store_dir", None)
    monkeypatch.setattr(_build, "build_dir", None)
    return builds


@pytest.mark.parametrize("part", ["capability", "nvcc", "torch_cuda", "source"])
def test_library_key_changes_with_the_toolchain_and_source(part):
    """The key of a library adds the compute capability, ``nvcc --version``
    and torch's CUDA version to the source-and-flags hash."""
    source = b"__global__ void k() {}"
    key = _build.library_key(source, TOOLS)
    assert key == _build.library_key(source, dict(TOOLS))      # deterministic
    other = {**TOOLS, part: {"capability": (8, 0), "nvcc": "release 12.8",
                             "torch_cuda": "12.8"}.get(part)}
    changed = (_build.library_key(source + b" ", TOOLS) if part == "source"
               else _build.library_key(source, other))
    assert changed != key


def test_nvcc_version_is_run_once_per_binary(tmp_path, monkeypatch):
    """``nvcc --version`` is read once and kept beside the libraries: a
    second process (here: a second call) runs no nvcc."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'Cuda compilation tools, release 12.4'\n")
    nvcc.chmod(0o755)
    runs = []
    real = _build.subprocess.run
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda *a, **kw: runs.append(a) or real(*a, **kw))
    first = _build.nvcc_version(str(nvcc), str(tmp_path / "store"))
    second = _build.nvcc_version(str(nvcc), str(tmp_path / "store"))
    assert first == second and "release 12.4" in first and len(runs) == 1
    os.utime(nvcc, ns=(0, 10 ** 9))        # another binary at that path: asked again
    _build.nvcc_version(str(nvcc), str(tmp_path / "store"))
    assert len(runs) == 2


def test_store_builds_once_and_a_later_process_finds_it(tmp_path, fake_toolchain, capfd):
    store = aot.AotStore(str(tmp_path / "aot"))
    lib = _build.load("decode_attention")
    assert lib.built and os.path.dirname(lib.path) == store.directory
    assert fake_toolchain == ["decode_attention.cu"]
    assert store.stored() == [os.path.basename(lib.path)]
    _build._loaded.clear()                   # a new process: nothing loaded yet
    again = _build.load("decode_attention")
    assert not again.built and again.path == lib.path and fake_toolchain == [
        "decode_attention.cu"]
    err = capfd.readouterr().err
    assert "[aot] built decode_attention" in err and "[aot] found decode_attention" in err


def test_a_stored_library_that_fails_to_load_is_rebuilt(tmp_path, fake_toolchain, capfd):
    aot.AotStore(str(tmp_path / "aot"))
    path = _build.library_path("decode_attention_quant")
    with open(path, "wb") as fh:
        fh.write(b"\x7fELF garbage")
    lib = _build.load("decode_attention_quant")
    assert lib.built and lib.path == path and fake_toolchain == ["decode_attention_quant.cu"]
    with open(path, "rb") as fh:
        assert fh.read().startswith(b"lib:")
    assert "[aot] stored library" in capfd.readouterr().err


def test_a_library_loaded_before_the_store_is_copied_into_it(tmp_path, fake_toolchain):
    compile_cache.enable(str(tmp_path / "cache"))
    first = _build.load("megakernel")
    assert os.path.dirname(first.path) == str(tmp_path / "cache")
    store = aot.AotStore(str(tmp_path / "aot"))
    assert _build.load("megakernel") is first and fake_toolchain == ["megakernel.cu"]
    assert store.stored() == [os.path.basename(first.path)]


def test_compile_cache_names_the_build_directory(tmp_path, fake_toolchain, monkeypatch):
    """``$MESHANYTHING_COMPILE_CACHE`` names where the libraries are
    built; unset, the package's ``_build``; a store wins over both."""
    monkeypatch.delenv("MESHANYTHING_COMPILE_CACHE", raising=False)
    assert compile_cache.enable() == _build.BUILD_DIR == _build.target_dir()
    monkeypatch.setenv("MESHANYTHING_COMPILE_CACHE", str(tmp_path / "cc"))
    assert compile_cache.enable() == str(tmp_path / "cc") == _build.target_dir()
    assert os.path.isdir(tmp_path / "cc")
    aot.AotStore(str(tmp_path / "aot"))
    assert _build.target_dir() == str(tmp_path / "aot")


@pytest.mark.parametrize("attn,lookahead,dtype,head_dim,want", [
    ("pallas", 0, torch.bfloat16, 64, "decode_attention"),
    ("pallas_int8", 0, torch.bfloat16, 64, "decode_attention_quant"),
    ("pallas_int4", 0, torch.float32, 8, "decode_attention_quant"),
    ("pallas", 8, torch.bfloat16, 64, "decode_attention_window"),
    ("pallas_int8", 8, torch.bfloat16, 64, "decode_attention_window"),
    ("pallas_int4", "adaptive", torch.bfloat16, 64, "decode_attention_window"),
    ("pallas", 4, torch.float32, 8, "decode_attention_fast"),
    ("pallas_int8", 4, torch.float32, 64, "decode_attention_fast"),
    ("megakernel", 0, torch.bfloat16, 64, "megakernel"),
])
def test_libraries_for_each_tier(attn, lookahead, dtype, head_dim, want):
    """The libraries ``precompile`` builds are the ones the tier's kernel
    wrappers load (K4's by ``mq_kernel_for``'s routing), with the residual
    add and post-LN kernel in every tier whose step runs it (all but K5),
    and the few-row product kernel in every bf16 tier."""
    fused = () if attn == "megakernel" else ("add_layer_norm",)
    products = ("gemv",) if dtype == torch.bfloat16 else ()
    assert aot.libraries_for(attn, lookahead, dtype, head_dim) == (want, *fused, *products)


# ---------------------------------------------------------------------------
# the runner


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = jax_small_config(n_max_triangles=4), small_test_config(n_max_triangles=4)
    params = jma.init_meshanything_params(jax.random.PRNGKey(7), jcfg)
    model = params_from_jax_numpy(jax.tree_util.tree_map(np.array, params), cfg)
    rng = np.random.default_rng(5)
    pcs = []
    for b in (1, 2, 1):
        pc = rng.normal(size=(b, cfg.perceiver.num_points, 6)).astype(np.float32)
        pc[..., :3] *= 0.3
        pc[..., 3:] /= np.linalg.norm(pc[..., 3:], axis=-1, keepdims=True)
        pcs.append(pc)
    return jcfg, cfg, params, model, pcs


def test_precompile_runs_nothing_on_the_cpu(bridged, monkeypatch):
    _, cfg, _, model, _ = bridged
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"built {name} on the CPU"))
    runner = PhaseRunner(model, cfg, bucket=16)
    assert runner.precompile(2) == {"libraries": [], "built": [], "graph_captures": 0,
                                    "capture_s": 0.0}
    assert list(runner._kept) == []


@pytest.mark.parametrize("kw,jax_kw", [
    ({"early_exit": False}, {"early_exit": False}),
    ({"lookahead": "adaptive", "adaptive_windows": (4, 8), "adaptive_check_iters": 8},
     {"lookahead": "adaptive", "adaptive_windows": (4, 8), "adaptive_check_iters": 8}),
    ({"lookahead": "adaptive", "adaptive_windows": (2, 4), "adaptive_check_iters": 16},
     {"lookahead": "adaptive", "adaptive_windows": (2, 4), "adaptive_check_iters": 16}),
])
def test_runner_options_match_jax(bridged, kw, jax_kw):
    """``early_exit``, ``adaptive_windows`` and ``adaptive_check_iters``
    against JAX's runner (interpret mode) on the same weights: tokens
    identical in f32 and the adaptive controller's trace equal."""
    jcfg, cfg, params, model, pcs = bridged
    runner = PhaseRunner(model, cfg, bucket=16, **kw)
    jrunner = JaxPhaseRunner(params, jcfg, bucket=16, attn="pallas", **jax_kw)
    out = runner(pcs[1])
    want = jrunner(jnp.asarray(pcs[1]))
    np.testing.assert_array_equal(out.token_ids.numpy(), np.asarray(want.token_ids))
    if kw.get("lookahead") == "adaptive":
        assert runner.window_trace and [tuple(t) for t in runner.window_trace] == [
            tuple(t) for t in jrunner.window_trace]
    else:   # without early exit the loop runs to the end: decode_steps is the whole length
        assert out.stats["decode_steps"] == cfg.generate_length - 1


MODES = {
    "exact": {},
    "int8": {"attn": "pallas_int8"},
    "int4_wq": {"attn": "pallas_int4", "wq": True},
    "lookahead4": {"lookahead": 4},
    "adaptive_int8": {"lookahead": "adaptive", "adaptive_windows": (2, 4),
                      "adaptive_check_iters": 4, "attn": "pallas_int8"},
}


@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_kept_state_refills_bit_equal_to_fresh_states(bridged, mode, sampling):
    """One runner takes requests at B=1, B=2 and B=1 again: it keeps a
    state for each batch size, refills the B=1 state for the third
    request, and every request's tokens (and, sampled, the generator's
    state after it) equal a fresh runner's on the same input."""
    _, cfg, _, model, pcs = bridged
    kept = PhaseRunner(model, cfg, bucket=16, **MODES[mode])

    def request(runner, pc, seed):
        gen = torch.Generator().manual_seed(seed) if sampling else None
        out = runner(pc, sampling=sampling, generator=gen)
        return out.token_ids, (None if gen is None else gen.get_state())

    for i, pc in enumerate(pcs):
        got, got_gen = request(kept, pc, 10 + i)
        want, want_gen = request(PhaseRunner(model, cfg, bucket=16, **MODES[mode]), pc, 10 + i)
        assert torch.equal(got, want), (mode, i)
        if sampling:
            assert torch.equal(got_gen, want_gen)
    assert list(kept._kept) == [(2, sampling), (1, sampling)]     # least recently used first


def test_kept_state_takes_a_completion_prompt(bridged):
    """A prompt request refills the kept state of its batch size, and a
    plain request after it does not see the prompt."""
    _, cfg, _, model, pcs = bridged
    prompt = torch.tensor([[0, 10, 11, 12, 13, 14, 15, 16, 17, 18]])
    kept = PhaseRunner(model, cfg, bucket=16)
    first = kept(pcs[0]).token_ids
    completed = kept(pcs[0], prompt_ids=prompt).token_ids
    again = kept(pcs[0]).token_ids
    fresh = PhaseRunner(model, cfg, bucket=16)(pcs[0], prompt_ids=prompt).token_ids
    assert torch.equal(completed, fresh) and torch.equal(completed[:, :10], prompt)
    assert torch.equal(first, again) and list(kept._kept) == [(1, False)]


def test_budget_counts_kept_states_and_drops_the_least_recent(bridged, monkeypatch):
    """On a card the estimate adds the other kept states' bytes; where the
    batch would not fit, the least recently used are dropped first."""
    _, cfg, _, model, pcs = bridged
    runner = PhaseRunner(model, cfg, bucket=16)
    runner(pcs[0])                      # keeps (1, False)
    runner(pcs[1])                      # keeps (2, False)
    seen = []

    def budget(*args, kept_bytes=0, keep=False, **kw):
        seen.append((args[1], kept_bytes, keep))
        if kept_bytes > 0:
            raise ValueError("does not fit")
        return 0

    monkeypatch.setattr(phases, "check_memory_budget", budget)
    monkeypatch.setattr(runner, "device", torch.device("cuda"))
    one = phases.kept_state_bytes(runner._kept[(1, False)].state)
    two = phases.kept_state_bytes(runner._kept[(2, False)].state)
    assert 0 < one < two
    runner._budget(4, 0, (4, False))    # a new key: both others are dropped, oldest first
    assert seen == [(4, one + two, True), (4, two, True), (4, 0, True)]
    assert list(runner._kept) == []


def test_budget_estimate_holds_the_kept_cache_through_detok():
    """``keep``: the cache and the int8 matrices stay live through detok,
    so the detok term holds them; ``kept_bytes`` is added whole."""
    from meshanything_tpu_torch.config import MeshAnythingConfig

    cfg = MeshAnythingConfig()
    kw = dict(param_bytes=int(1e9), limit_bytes=int(1e15))
    base = phases.check_memory_budget(cfg, 64, **kw)
    assert phases.check_memory_budget(cfg, 64, kept_bytes=123, **kw) == base + 123
    kept = phases.check_memory_budget(cfg, 64, keep=True, **kw)
    # B=64: the decode term is the larger without the kept cache, the detok term with it
    assert base < kept < base + phases.estimate_kv_bytes(cfg, 64)
    with pytest.raises(ValueError, match="kept for other batch sizes 2.0 GB"):
        phases.check_memory_budget(cfg, 1, param_bytes=int(1e9), limit_bytes=int(3e9),
                                   kept_bytes=int(2e9))


# ---------------------------------------------------------------------------
# packaging


def test_setup_ships_every_csrc_include_and_native_source():
    """Every ``#include "..."`` of the port's CUDA sources, and the native
    geometry source, matches a ``package_data`` pattern of setup.py: an
    installed port can build every kernel."""
    tree = ast.parse(open(os.path.join(REPO, "setup.py")).read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", "") == "setup")
    package_data = ast.literal_eval(next(k.value for k in call.keywords
                                         if k.arg == "package_data"))
    patterns = package_data["meshanything_tpu_torch"]
    pkg = os.path.join(REPO, "meshanything_tpu_torch")
    needed = {"native/geom.cpp"}
    for cu in glob.glob(os.path.join(pkg, "csrc", "*.cu")):
        needed.add(os.path.relpath(cu, pkg))
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', open(cu).read(), flags=re.M):
            needed.add(os.path.normpath(os.path.join("csrc", inc)))
    assert {"csrc/row_stream.cuh", "csrc/split_fold.cuh", "csrc/quant_codes.cuh"} <= needed
    for rel in sorted(needed):
        assert os.path.isfile(os.path.join(pkg, rel)), rel
        assert any(fnmatch.fnmatch(rel, p) for p in patterns), (rel, patterns)
