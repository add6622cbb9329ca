"""The serving path of the PyTorch port against the JAX package's, on the
small config in f32 with weights bridged from the JAX tree (JAX's Pallas
kernels in interpret mode): ``PhaseRunner``, the micro-batcher (the seven
cases of tests/test_batching.py), ``ServingEngine`` over HTTP (the same
OBJ text, processed input and PNG bytes as JAX's server for a plain, an
X-MC and a completion request; 400s for malformed requests), the gradio
frontend through a stub, and concurrent pass-through requests against
serial ones. Every batcher, engine and server a test starts is closed."""
import base64
import json
import struct
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.runtime.phases import PhaseRunner as JaxPhaseRunner
from meshanything_tpu_torch import serving
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.geometry import Mesh, save_obj
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.runtime.batching import BatchingRunner
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy
from meshanything_tpu_torch.runtime.phases import PhaseRunner
from meshanything_tpu_torch.runtime.profiling import PhaseTimer

CUBE_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                   [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
CUBE_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                   [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
TET_V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
TET_F = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]])


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_small_config(n_max_triangles=2), small_test_config(n_max_triangles=2)
    params = jma.init_meshanything_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax_numpy(jax.tree_util.tree_map(np.array, params), cfg)
    return jcfg, params, cfg, model


def _pcs(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, cfg.perceiver.num_points, 6)).astype(np.float32) * 0.5
            for _ in range(n)]


# ---------------------------------------------------------------------------
# PhaseRunner


@pytest.mark.parametrize("case", ["exact", "int8_prompt", "adaptive"])
def test_phase_runner_matches_jax(setup, case):
    """The port's runner and JAX's on the same batch: tokens identical,
    coords to 1e-6; with a prompt the stream starts with it; the adaptive
    window's trace is JAX's."""
    jcfg, params, cfg, model = setup
    kw, call = {}, {}
    if case == "int8_prompt":
        kw = {"attn": "pallas_int8"}
        call = {"prompt_ids": np.array([[0, 70, 4, 9, 33, 12], [0, 5, 5, 5, 100, 3]])}
    if case == "adaptive":
        kw = {"lookahead": "adaptive"}
    pc = np.concatenate(_pcs(cfg, 2, seed=3))
    runner = PhaseRunner(model, cfg, bucket=16, **kw)
    timer = PhaseTimer()
    out = runner(pc, timer=timer, **call)
    jrunner = JaxPhaseRunner(params, jcfg, bucket=16, **{"attn": "pallas", **kw})
    jcall = {k: jnp.asarray(v, jnp.int32) for k, v in call.items()}
    ref = jrunner(jnp.asarray(pc), **jcall)
    np.testing.assert_array_equal(out.token_ids.numpy(), np.asarray(ref.token_ids))
    np.testing.assert_allclose(out.face_coords.numpy(), np.asarray(ref.face_coords),
                               rtol=0, atol=1e-6)
    assert out.face_coords.device.type == "cpu" and out.face_coords.dtype == torch.float32
    assert list(timer.summary()) == ["encode", "decode", "detok"]
    assert out.stats["capture_s"] == 0 and out.stats["graph_captures"] == 0     # no card
    if "prompt_ids" in call:
        np.testing.assert_array_equal(out.token_ids[:, :6].numpy(), call["prompt_ids"])
        assert out.stats["decode_steps"] < cfg.generate_length - 6
    if case == "adaptive":
        assert runner.window_trace and [tuple(t) for t in runner.window_trace] == [
            tuple(t) for t in jrunner.window_trace]
        assert out.stats["window_trace"] == runner.window_trace


def test_phase_runner_refuses_what_is_not_ported(setup):
    """What the runner still refuses: the window loop over the megakernel
    tier (JAX runs its XLA tier there), a bad window and, as JAX's runner,
    an adaptive pair that is not (small, big). The ahead-of-time store and
    precompile are ported (tests/test_torch_warm_start.py)."""
    _, _, cfg, model = setup
    with pytest.raises(NotImplementedError, match="not ported"):
        PhaseRunner(model, cfg, attn="megakernel", lookahead=4)
    with pytest.raises(ValueError, match="window width or 'adaptive'"):
        PhaseRunner(model, cfg, lookahead=-1)
    for pair in ((8, 8), (16, 8), (4,)):
        with pytest.raises(ValueError, match=r"adaptive_windows must be \(small, big\)"):
            PhaseRunner(model, cfg, lookahead="adaptive", adaptive_windows=pair)


# ---------------------------------------------------------------------------
# BatchingRunner: the seven cases of tests/test_batching.py


class _CountingRunner:
    """PhaseRunner-shaped test double over the real model: records the
    batch size of every launch."""

    def __init__(self, model, cfg):
        self.model = model
        self.cfg = cfg
        self.calls = []

    def __call__(self, pc, *, sampling=False, generator=None, prompt_ids=None):
        self.calls.append(int(np.asarray(pc).shape[0]))
        pc = torch.as_tensor(np.asarray(pc, np.float32))
        with torch.no_grad():
            if prompt_ids is not None:
                return ma.complete(self.model, self.cfg, pc, np.zeros((pc.shape[0], 1, 3, 3)),
                                   bucket=16)
            return ma.generate(self.model, self.cfg, pc, sampling=sampling, generator=generator,
                               bucket=16)


@pytest.fixture
def make_batcher():
    """BatchingRunners closed at teardown: a leaked worker pins its
    runner's weights for the life of the process."""
    created = []

    def _make(*a, **kw):
        b = BatchingRunner(*a, **kw)
        created.append(b)
        return b

    yield _make
    for b in created:
        b.close()
        assert not b._thread.is_alive()


def _reference_tokens(model, cfg, pc):
    with torch.no_grad():
        return ma.generate(model, cfg, torch.from_numpy(pc), bucket=16).token_ids.numpy()


def test_concurrent_requests_coalesce(setup, make_batcher):
    """Four concurrent submissions coalesce into fewer launches, each
    caller receives ITS OWN row, and results equal the unbatched path."""
    _, _, cfg, model = setup
    base = _CountingRunner(model, cfg)
    batcher = make_batcher(base, batch_sizes=(1, 2, 4), max_wait_s=0.3)
    pcs = _pcs(cfg, 4, seed=1)
    refs = [_reference_tokens(model, cfg, p) for p in pcs]
    results, errors = [None] * 4, []

    def worker(i):
        try:
            results[i] = batcher(pcs[i])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
        time.sleep(0.01)  # arrive within the batching window
    for t in threads:
        t.join(timeout=300)
    assert not errors and all(r is not None for r in results)
    assert len(base.calls) < 4
    assert all(c in (1, 2, 4) for c in base.calls)
    assert batcher.batch_sizes_served == base.calls
    for i, r in enumerate(results):
        assert r.token_ids.shape[0] == 1
        np.testing.assert_array_equal(r.token_ids.numpy(), refs[i], err_msg=f"request {i}")


def test_close_stops_worker_thread(setup, make_batcher):
    """close() terminates the worker, is idempotent, and a close racing an
    in-flight batch still serves that batch."""
    _, _, cfg, model = setup
    base = _CountingRunner(model, cfg)
    batcher = make_batcher(base, batch_sizes=(1, 2), max_wait_s=0.2)
    pc = _pcs(cfg, 1, seed=2)[0]
    out = [None]
    t = threading.Thread(target=lambda: out.__setitem__(0, batcher(pc)))
    t.start()
    time.sleep(0.05)       # request in flight (worker inside its wait window)
    batcher.close()        # sentinel races the accumulating batch
    t.join(timeout=120)
    assert out[0] is not None
    batcher._thread.join(timeout=60)
    assert not batcher._thread.is_alive()
    batcher.close()


def test_single_request_uses_small_program(setup, make_batcher):
    """A lone request must not pay a padded max-batch decode."""
    _, _, cfg, model = setup
    base = _CountingRunner(model, cfg)
    batcher = make_batcher(base, batch_sizes=(1, 4), max_wait_s=0.01)
    out = batcher(_pcs(cfg, 1, seed=3)[0])
    assert out.token_ids.shape == (1, cfg.generate_length)
    assert base.calls == [1] and batcher.batch_sizes_served == [1]


def test_batch_failure_propagates(setup, make_batcher):
    _, _, cfg, _ = setup

    class _Boom:
        def __call__(self, pc, **kw):
            raise RuntimeError("device fell over")

    batcher = make_batcher(_Boom(), batch_sizes=(1, 2), max_wait_s=0.01)
    with pytest.raises(RuntimeError, match="device fell over"):
        batcher(_pcs(cfg, 1)[0])


def test_prompt_requests_bypass_batching(setup, make_batcher):
    _, _, cfg, model = setup
    base = _CountingRunner(model, cfg)
    batcher = make_batcher(base, batch_sizes=(1, 2), max_wait_s=0.01)
    out = batcher(_pcs(cfg, 1)[0], prompt_ids=torch.zeros((1, 10), dtype=torch.int64))
    assert out.token_ids.shape[0] == 1
    assert batcher.batch_calls == 0


def test_sampling_requests_bypass_batching(setup, make_batcher):
    """Sampled requests go straight through, so that each request's own
    generator governs its stream."""
    _, _, cfg, model = setup
    base = _CountingRunner(model, cfg)
    batcher = make_batcher(base, batch_sizes=(1, 2), max_wait_s=0.01)
    pc = _pcs(cfg, 1, seed=4)[0]
    out = batcher(pc, sampling=True, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        ref = ma.generate(model, cfg, torch.from_numpy(pc), sampling=True,
                          generator=torch.Generator().manual_seed(7), bucket=16)
    np.testing.assert_array_equal(out.token_ids.numpy(), ref.token_ids.numpy())
    assert batcher.batch_calls == 0


def test_serving_engine_batching_wires_up(setup, tmp_path, make_batcher):
    """ServingEngine over a batcher: two concurrent generations share one
    launch; ServingEngine(batching=4) builds its own batcher, and close()
    stops it."""
    _, _, cfg, model = setup
    base = _CountingRunner(model, cfg)
    engine = serving.ServingEngine(model, cfg, bucket=16, runner=base,
                                   artifacts_dir=str(tmp_path))
    engine._runner = make_batcher(base, batch_sizes=(1, 2), max_wait_s=0.3)
    results = [None, None]

    def worker(i):
        results[i] = engine.generate_from_mesh(CUBE_V, CUBE_F, seed=0, render="off",
                                               export_artifacts=False)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
        time.sleep(0.01)
    for t in threads:
        t.join(timeout=300)
    assert all(r is not None for r in results)
    assert base.calls.count(2) >= 1
    own = serving.ServingEngine(model, cfg, bucket=16, batching=4, artifacts_dir=str(tmp_path))
    try:
        assert isinstance(own._runner, BatchingRunner) and own._runner._sizes == [1, 2, 4]
        res = own.generate_from_mesh(CUBE_V, CUBE_F, seed=0, render="off", export_artifacts=False)
        assert own._runner.batch_sizes_served == [1] and res["faces_generated"] >= 0
    finally:
        own.close()
        own.close()
    assert not own._runner._thread.is_alive()


# ---------------------------------------------------------------------------
# ServingEngine over HTTP, against the JAX package's server


def _post(port, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _obj_bytes(tmp_path, v, f, name):
    path = tmp_path / name
    save_obj(Mesh(v, f), str(path))
    return path.read_bytes()


@pytest.fixture(scope="module")
def servers(setup, tmp_path_factory):
    """The port's server (serve_http on a free port, in a thread) and the
    JAX package's, on the same weights; both shut down and closed."""
    from http.server import ThreadingHTTPServer

    from meshanything_tpu.serving import ServingEngine as JaxServingEngine
    from meshanything_tpu.serving import _make_handler as jax_handler

    jcfg, params, cfg, model = setup
    tmp = tmp_path_factory.mktemp("serving")
    engine = serving.ServingEngine(model, cfg, bucket=16, artifacts_dir=str(tmp / "port"))
    ready = []
    thread = threading.Thread(target=serving.serve_http, args=(engine, "127.0.0.1", 0),
                              kwargs={"ready": ready.append}, daemon=True)
    thread.start()
    deadline = time.time() + 60
    while not ready:
        assert time.time() < deadline and thread.is_alive()
        time.sleep(0.01)
    jengine = JaxServingEngine(params, jcfg, bucket=16, attn="pallas",
                               artifacts_dir=str(tmp / "jax"))
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), jax_handler(jengine))
    jthread = threading.Thread(target=jserver.serve_forever, daemon=True)
    jthread.start()
    yield ready[0].server_address[1], jserver.server_address[1], engine, tmp
    ready[0].shutdown()
    thread.join(timeout=60)
    jserver.shutdown()
    jserver.server_close()
    jthread.join(timeout=60)
    assert not thread.is_alive() and not jthread.is_alive()


def test_http_health_and_form(servers):
    port = servers[0]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
        assert r.read() == b"ok"
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60) as r:
        assert b"<form" in r.read()
    status, _, _ = _post(port, b"", {})            # no body: an empty OBJ, a client error
    assert status == 400
    req = urllib.request.Request(f"http://127.0.0.1:{port}/other", data=b"x", method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=60)
    assert err.value.code == 404


@pytest.mark.parametrize("kind", ["plain", "mc", "completion"])
def test_http_raw_obj_equals_jax(servers, tmp_path, kind):
    """Raw-OBJ mode: status, face counts and the OBJ text equal the JAX
    server's; the render paths are announced and land."""
    port, jport, _, _ = servers
    headers = {"X-Seed": "3"}
    v, f = CUBE_V, CUBE_F
    if kind == "mc":
        v, f = TET_V, TET_F
        headers.update({"X-MC": "1", "X-Renders": "0"})
    if kind == "completion":
        partial = b"v 0.1 0.1 0.0\nv 0.9 0.1 0.0\nv 0.5 0.8 0.0\nf 1 2 3\n"
        headers["X-Partial-Obj-B64"] = base64.b64encode(partial).decode()
    body = _obj_bytes(tmp_path, v, f, "in.obj")
    status, hdrs, text = _post(port, body, headers)
    jstatus, jhdrs, jtext = _post(jport, body, headers)
    assert status == jstatus == 200
    assert text == jtext and text.startswith(b"# face_color")
    for key in ("X-Faces-Generated", "X-Faces-Final"):
        assert hdrs[key] == jhdrs[key]
    assert float(hdrs["X-Capture-S"]) == 0.0          # no card, no graph
    if kind == "mc":
        assert "X-Input-Render" not in hdrs
        return
    assert hdrs["X-Renders-Async"] == "1"
    deadline = time.time() + 60
    import os

    while not all(os.path.exists(hdrs[k]) for k in ("X-Input-Render", "X-Output-Render")):
        assert time.time() < deadline
        time.sleep(0.05)


def test_http_json_equals_jax(servers, tmp_path):
    """JSON mode: both OBJs and both wireframe PNGs equal the JAX
    server's, byte for byte."""
    port, jport, _, _ = servers
    body = _obj_bytes(tmp_path, CUBE_V, CUBE_F, "cube.obj")
    headers = {"X-Seed": "1", "Accept": "application/json"}
    status, _, payload = _post(port, body, headers)
    jstatus, _, jpayload = _post(jport, body, headers)
    assert status == jstatus == 200
    mine, ref = json.loads(payload), json.loads(jpayload)
    for key in ("output_obj", "input_obj", "faces_generated", "faces_final",
                "output_render_png_b64", "input_render_png_b64"):
        assert mine[key] == ref[key], key
    assert base64.b64decode(mine["output_render_png_b64"])[:8] == b"\x89PNG\r\n\x1a\n"
    assert mine["capture_s"] == 0.0 and mine["artifact_export_s"] > 0


@pytest.mark.parametrize("bad", ["base64", "truncated_stl", "oversized_prompt"])
def test_http_client_errors_are_400_as_in_jax(servers, tmp_path, bad):
    port, jport, _, _ = servers
    body = _obj_bytes(tmp_path, CUBE_V, CUBE_F, "cube.obj")
    headers = {}
    if bad == "base64":
        headers["X-Partial-Obj-B64"] = "!!!not-base64!!!"
    if bad == "truncated_stl":
        tri = CUBE_V[CUBE_F].astype(np.float32)
        stl = b"solid" + b"\x00" * 75 + struct.pack("<I", len(tri)) + b"".join(
            struct.pack("<3f", 0, 0, 0) + t.tobytes() + b"\x00\x00" for t in tri)
        body = stl[:84 + 50 * 5]
    if bad == "oversized_prompt":
        big = "".join(f"v {i * 0.01} 0 0\nv {i * 0.01} 0.1 0\nv {i * 0.01} 0 0.1\n"
                      f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n" for i in range(4)).encode()
        headers["X-Partial-Obj-B64"] = base64.b64encode(big).decode()
    status, _, payload = _post(port, body, headers)
    jstatus, _, jpayload = _post(jport, body, headers)
    assert status == jstatus == 400
    assert json.loads(payload)["error"] == json.loads(jpayload)["error"]


def test_http_server_faults_are_500(servers, tmp_path, monkeypatch):
    port, _, engine, _ = servers

    def broken(*a, **kw):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(engine, "generate_from_mesh", broken)
    status, _, payload = _post(port, _obj_bytes(tmp_path, CUBE_V, CUBE_F, "c.obj"))
    assert status == 500 and json.loads(payload)["error"] == "RuntimeError: device fell over"


def test_sampled_requests_follow_their_seed(setup, tmp_path):
    """The same seed twice gives the same OBJ, two seeds different ones."""
    _, _, cfg, model = setup
    engine = serving.ServingEngine(model, cfg, bucket=16, artifacts_dir=str(tmp_path))
    objs = []
    for seed in (5, 5, 6):
        res = engine.generate_from_mesh(CUBE_V, CUBE_F, seed=seed, do_sampling=True,
                                        render="off")
        objs.append(open(res["output_obj_path"]).read())
    assert objs[0] == objs[1] != objs[2]
    engine.close()


def test_concurrent_pass_through_requests_equal_serial_ones(setup, tmp_path):
    """Sampled and completion requests pass the batcher on the callers'
    threads; the runner's lock serialises their device work, and each
    result is the one the same request gives alone."""
    _, _, cfg, model = setup
    engine = serving.ServingEngine(model, cfg, bucket=16, batching=2,
                                   artifacts_dir=str(tmp_path))
    partial = CUBE_V[CUBE_F[:1]]
    jobs = [dict(seed=s, do_sampling=True) for s in (1, 2, 3)] + [
        dict(seed=0, partial_faces=partial), dict(seed=4, do_sampling=True, partial_faces=partial)]

    def run(job):
        res = engine.generate_from_mesh(CUBE_V, CUBE_F, render="off", **job)
        return open(res["output_obj_path"]).read()

    try:
        serial = [run(job) for job in jobs]
        results, errors = [None] * len(jobs), []

        def worker(i):
            try:
                results[i] = run(jobs[i])
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors and results == serial
        assert engine._runner.batch_calls == 0
    finally:
        engine.close()


def test_serve_gradio_with_a_stub(setup, tmp_path, monkeypatch):
    """serve_gradio's component tree and click wiring (gradio is absent:
    a stub module records them, as tests/test_gradio_stub.py does for the
    JAX package), then the recorded do_inference driven end to end."""
    import os
    import types

    class Component:
        def __init__(self, kind, *args, **kwargs):
            self.kind, self.args, self.kwargs, self.clicks = kind, args, kwargs, []

        def click(self, fn=None, inputs=None, outputs=None, **kw):
            self.clicks.append({"fn": fn, "inputs": inputs, "outputs": outputs})

    class Context(Component):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def launch(self, **kw):
            self.clicks.append(kw)

    made = []
    stub = types.ModuleType("gradio")
    for kind in ("Blocks", "Row", "Column", "Group"):
        setattr(stub, kind, lambda *a, _k=kind, **kw: made.append(Context(_k, *a, **kw))
                or made[-1])
    for kind in ("Markdown", "Model3D", "Checkbox", "Number", "Button", "Image", "Examples"):
        setattr(stub, kind, lambda *a, _k=kind, **kw: made.append(Component(_k, *a, **kw))
                or made[-1])
    monkeypatch.setitem(sys.modules, "gradio", stub)

    _, _, cfg, model = setup
    engine = serving.ServingEngine(model, cfg, bucket=16, artifacts_dir=str(tmp_path / "a"))
    exdir = tmp_path / "examples"
    exdir.mkdir()
    ex_obj = str(exdir / "cube.obj")
    save_obj(Mesh(CUBE_V, CUBE_F), ex_obj)
    serving.serve_gradio(engine, examples_dir=str(exdir), server_port=1234)

    blocks = [c for c in made if c.kind == "Blocks"]
    assert len(blocks) == 1 and blocks[0].clicks == [{"server_port": 1234}]
    kinds = [c.kind for c in made]
    assert (kinds.count("Model3D"), kinds.count("Checkbox"), kinds.count("Image"),
            kinds.count("Number"), kinds.count("Examples")) == (3, 2, 2, 1, 1)
    examples = next(c for c in made if c.kind == "Examples")
    assert examples.kwargs["examples"] == [ex_obj] and examples.kwargs["cache_examples"] is False
    button = next(c for c in made if c.kind == "Button")
    assert button.args == ("Generate",) and len(button.clicks) == 1
    wiring = button.clicks[0]
    assert len(wiring["inputs"]) == 4 and len(wiring["outputs"]) == 4
    assert wiring["fn"] is examples.kwargs["fn"]
    out = wiring["fn"](ex_obj, sample_seed=0, do_sampling=False, do_marching_cubes=False)
    input_obj, input_png, output_obj, output_png = out
    assert os.path.basename(input_obj).startswith("processed_input_")
    assert os.path.basename(output_obj).startswith("output_")
    for p in out:
        assert os.path.exists(p), p
    with open(input_png, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_serving_main_serves_http_without_gradio(setup, monkeypatch):
    """``python -m meshanything_tpu_torch.serving``: the CLI's flags build
    the engine (--batchsize_per_gpu its batcher, --fast its tier), and
    without gradio it serves over HTTP."""
    _, _, cfg, model = setup
    from meshanything_tpu_torch import cli

    seen = {}
    monkeypatch.setitem(sys.modules, "gradio", None)
    monkeypatch.setattr(cli, "build_config", lambda args: cfg)
    monkeypatch.setattr(cli, "load_params", lambda args, cfg_, device: model)

    def fake_serve(engine, *a, **kw):
        seen["runner"] = engine._runner
        engine.close()

    monkeypatch.setattr(serving, "serve_http", fake_serve)
    serving.main(["--random_weights", "--device", "cpu", "--fast", "--batchsize_per_gpu", "4"])
    batcher = seen["runner"]
    assert isinstance(batcher, BatchingRunner) and not batcher._thread.is_alive()
    runner = batcher._runner
    assert (runner.attn, runner.lookahead, runner.wq) == ("pallas_int8", 8, True)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        serving.main(["--random_weights", "--device", "cpu", "--multihost"])
