"""Serving layer of the PyTorch port: the app.py equivalent (reference
app.py:1-270; the port of ``meshanything_tpu/serving.py``).

    python -m meshanything_tpu_torch.serving [--pretrained_weights W] [--fast] \
        [--batchsize_per_gpu 4] [--device cuda] [--aot_dir D] [--precompile]
    python app_torch.py ...                     # the same

Two frontends over one ServingEngine:
  * gradio Blocks UI when gradio is installed — same surface as the
    reference: 3D upload, seed, sampling checkbox, marching-cubes
    checkbox, processed-input + generated-mesh OBJ viewers, wireframe
    preview renders of both, and an examples gallery (app.py:217-269);
  * a dependency-free stdlib HTTP server: GET /health answers "ok", GET /
    serves a minimal upload form, POST /generate accepts a mesh body (OBJ,
    PLY, STL, OFF or GLB, sniffed by ``detect_mesh_format``) and returns
    the generated OBJ — or, with ``Accept: application/json``, a JSON
    document carrying both OBJ artifacts and both wireframe renders
    (base64 PNG), mirroring the reference do_inference's four outputs
    (app.py:172). Headers: ``X-Seed``, ``X-Sampling: 1``, ``X-MC: 1``
    (marching-cubes watertighting), ``X-Renders: 0`` (no previews),
    ``X-Partial-Obj-B64`` (mesh completion from a base64 OBJ of faces in
    the upload's coordinates). A malformed request is a 400 with the
    validation message, a fault past validation a 500.

Per-request flow mirrors app.py:95-172: optional marching-cubes
watertighting, 4096-point sampling, mesh-bbox normalization of both
mesh and pc, input-mesh cleanup (merge/unique/fix_normals) with orange
vertex colors and a timestamped ``processed_input_*.obj`` export, then
generation, output cleanup with orange vertex + brown face colors and a
timestamped ``output_*.obj`` export, and wireframe renders of both.

Normalization follows the *app* variant (mesh-bbox, app.py:108-114),
which differs from the CLI's pc-bbox variant (main.py:51-53).

The device side is one ``runtime/phases.py::PhaseRunner``, which runs one
generation at a time (its lock serialises the device work of the HTTP
handler threads and of the micro-batcher's worker); with ``batching`` a
``runtime/batching.py::BatchingRunner`` coalesces concurrent greedy
requests into padded batched decodes. On a card the runner keeps each
batch size's decode graphs across requests: the first request of a batch
size (or ``--precompile``, for every size the batcher pads to) captures
them, and its seconds are reported as ``capture_s`` beside ``latency_s``
(0 for the requests that replay them). ``--aot_dir`` is the store of the
built kernel libraries (``runtime/aot.py``).
"""
from __future__ import annotations

import base64
import contextlib
import json
import os
import tempfile
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from meshanything_tpu_torch.geometry import (
    Mesh,
    detect_mesh_format,
    faces_to_mesh,
    load_mesh,
    normalize_mesh_app,
    save_obj,
)
from meshanything_tpu_torch.geometry.postprocess import (
    fix_normals,
    merge_vertices,
    remove_degenerate_and_duplicate_faces,
)
from meshanything_tpu_torch.geometry.sample import sample_surface_with_normals

ORANGE = np.array([255, 165, 0, 255], dtype=np.uint8)   # app.py:120
BROWN = np.array([165, 42, 42, 255], dtype=np.uint8)    # app.py:165


class ServingEngine:
    """Load-once model + per-request generation (app.py:16-25,95-174)."""

    def __init__(self, model, cfg, *, bucket: int = 512, attn: str = "auto",
                 lookahead: "int | str" = 0, wq: bool = False,
                 artifacts_dir: Optional[str] = None, runner=None,
                 aot_dir: Optional[str] = None, batching: int = 0):
        """``model``: the port's ``MeshAnything`` on its device.
        ``batching`` > 1 wraps the runner in the micro-batcher
        (runtime/batching.py): concurrent greedy requests coalesce into
        one padded batched decode of up to that many rows (padded to 1,
        2, 4 or ``batching``), keeping the per-request API. ``runner`` injects a
        PhaseRunner-shaped callable in place of the engine's own;
        ``aot_dir`` is the store of the built kernel libraries
        (``runtime/aot.py``)."""
        from meshanything_tpu_torch.runtime.phases import PhaseRunner

        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.artifacts_dir = artifacts_dir or tempfile.mkdtemp(prefix="meshanything_")
        if runner is None:
            runner = PhaseRunner(model, cfg, bucket=bucket, attn=attn, lookahead=lookahead,
                                 wq=wq, aot_dir=aot_dir)
        # the runner whose lock serialises the device work (a generator made on a
        # card while another thread captures a graph would spoil the capture)
        self._device_lock = getattr(runner, "lock", None) or contextlib.nullcontext()
        self._device_runner = runner       # the PhaseRunner (or the injected one)
        self.batch_sizes = (1,)
        if batching and batching > 1:
            from meshanything_tpu_torch.runtime.batching import BatchingRunner

            self.batch_sizes = tuple(sorted({s for s in (1, 2, 4, batching) if s <= batching}))
            runner = BatchingRunner(runner, batch_sizes=self.batch_sizes)
        self._runner = runner

    def precompile(self) -> list:
        """The device runner's ``precompile`` for every batch size the
        engine runs (greedy; a sampled request runs at batch 1) -> the
        reports."""
        return [self._device_runner.precompile(b) for b in self.batch_sizes]

    def close(self) -> None:
        """Release the engine's runner (stops the micro-batcher's worker
        thread if batching is enabled). Idempotent."""
        close = getattr(self._runner, "close", None)
        if close is not None:
            close()

    def _generator(self, seed: int) -> torch.Generator:
        """The request's own generator on the model's device, seeded."""
        with self._device_lock:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        return generator

    def generate_from_mesh(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        *,
        seed: int = 0,
        do_sampling: bool = False,
        do_marching_cubes: bool = False,
        export_artifacts: bool = True,
        partial_faces: Optional[np.ndarray] = None,
        render: str = "sync",
    ):
        """partial_faces (nf, 3, 3), in the SAME coordinate space as the
        uploaded mesh (e.g. faces cut from it): mesh completion — the
        faces get the same mesh-bbox normalization as the condition
        (the server holds that transform; clients cannot apply it), are
        discretized to a [bos ‖ face tokens] prompt, and the decoder
        continues them (models/meshanything.py::complete semantics
        through the phase runner).

        render: "sync" (write the two wireframe previews before
        returning — gradio-parity), "async" (render on a background
        thread; result carries ``render_thread`` to join when the PNGs
        are needed), or "off". The previews are host-side NumPy
        rasterization, so the HTTP API defers them off the request thread
        by default.

        The result carries the mesh, the processed input, face counts,
        ``latency_s`` (the model pipeline) and ``capture_s`` (the decode
        graph's capture in it, 0 off the card); with ``export_artifacts``
        the artifacts' paths and ``artifact_export_s``."""
        t0 = time.time()
        mesh = Mesh(np.asarray(vertices, float), np.asarray(faces, np.int64))
        if do_marching_cubes:
            from meshanything_tpu_torch.geometry.sdf import export_to_watertight

            mesh = export_to_watertight(mesh)

        rng = np.random.default_rng(seed)
        pc = sample_surface_with_normals(
            mesh.vertices, mesh.faces, self.cfg.perceiver.num_points, rng
        )

        # app normalization: mesh bbox for both mesh and pc (app.py:108-114)
        norm_vertices, pc_coor = normalize_mesh_app(mesh.vertices, pc[:, :3].astype(np.float64))

        # processed-input cleanup + orange vertex colors (app.py:116-127).
        # The marched shell is already consistently outward-oriented by
        # construction (geometry/marching.py), so the per-face BFS repair
        # is skipped there: on a 128^3 isosurface (~1e5-1e6 faces) it
        # would stall the request for minutes.
        in_v, in_f = merge_vertices(norm_vertices, mesh.faces)
        in_f = remove_degenerate_and_duplicate_faces(in_f)
        if not do_marching_cubes:
            in_f = fix_normals(in_v, in_f)
        input_mesh = Mesh(in_v, in_f,
                          vertex_colors=np.tile(ORANGE, (len(in_v), 1)))

        normals = pc[:, 3:].astype(np.float64)
        norms = np.linalg.norm(normals, axis=-1)
        if not (norms > 0.99).all():
            raise ValueError("normals should be unit vectors")
        pc_normal = np.concatenate([pc_coor, normals], axis=-1).astype(np.float16)

        pc_in = np.asarray(pc_normal, np.float32)[None]
        generator = self._generator(seed) if do_sampling else None
        prompt = None
        if partial_faces is not None:
            from meshanything_tpu_torch.models.meshanything import build_face_prompt

            # same mesh-bbox transform as the condition above
            # (app.py:108-114): center on the input mesh's bbox midpoint,
            # scale by its max extent -> model output space [-0.5, 0.5]
            bounds = np.array([mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)])
            center = (bounds[0] + bounds[1]) / 2
            extent = max((bounds[1] - bounds[0]).max(), 1e-12)
            partial_norm = (np.asarray(partial_faces, np.float64) - center) / extent
            prompt = build_face_prompt(self.cfg, partial_norm[None])
        if prompt is not None:
            out = self._runner(pc_in, sampling=do_sampling, generator=generator,
                               prompt_ids=prompt)
        else:
            # plain call keeps injected runners free of the prompt_ids kwarg
            out = self._runner(pc_in, sampling=do_sampling, generator=generator)
        coords = out.face_coords.float().numpy()[0]
        stats = out.stats or {}

        # output cleanup + orange vertex / brown face colors (app.py:144-168)
        gen_mesh = faces_to_mesh(coords, face_colors=BROWN)
        gen_mesh.vertex_colors = np.tile(ORANGE, (len(gen_mesh.vertices), 1))

        result = {
            "mesh": gen_mesh,
            "input_mesh": input_mesh,
            "faces_generated": int(np.sum(~np.isnan(coords[:, 0, 0]))),
            "faces_final": len(gen_mesh.faces),
            # model-pipeline latency only — artifact export (renders +
            # disk writes) is reported separately below
            "latency_s": time.time() - t0,
            "capture_s": stats.get("capture_s", 0.0),
        }

        if export_artifacts:
            import threading
            import uuid

            from meshanything_tpu_torch.runtime.render import wireframe_render

            t1 = time.time()
            # timestamp dodges client caches (app.py:125,169); the uuid
            # suffix prevents concurrent same-second requests from
            # overwriting each other under the threaded HTTP server
            ts = f"{int(time.time())}_{uuid.uuid4().hex[:8]}"
            os.makedirs(self.artifacts_dir, exist_ok=True)

            def apath(name):
                return os.path.join(self.artifacts_dir, name)

            def preview(mesh_):
                # cap the preview size: rasterizing 1e5+ faces stalls
                # the host; subsample for the render only
                if len(mesh_.faces) > 20000:
                    sel = np.linspace(0, len(mesh_.faces) - 1, 20000).astype(int)
                    return mesh_.vertices, mesh_.faces[sel]
                return mesh_.vertices, mesh_.faces

            result["input_obj_path"] = apath(f"processed_input_{ts}.obj")
            save_obj(input_mesh, result["input_obj_path"])
            result["output_obj_path"] = apath(f"output_{ts}.obj")
            save_obj(gen_mesh, result["output_obj_path"])

            if render != "off":
                in_png = apath(f"combined_mesh_view_input_{ts}.png")
                out_png = apath(f"combined_mesh_view_output_{ts}.png")
                in_args = preview(input_mesh)
                out_args = preview(gen_mesh)

                def do_renders():
                    wireframe_render(*in_args, in_png)
                    wireframe_render(*out_args, out_png)

                result["input_render_path"] = in_png
                result["output_render_path"] = out_png
                if render == "async":
                    t = threading.Thread(target=do_renders, daemon=True)
                    t.start()
                    result["render_thread"] = t
                else:
                    do_renders()
            result["artifact_export_s"] = time.time() - t1

        return result


_FORM = b"""<!doctype html><title>MeshAnything (PyTorch)</title>
<h2>MeshAnything (PyTorch)</h2>
<form method=post action=/generate enctype=multipart/form-data>
OBJ file: <input type=file name=file><br>
seed: <input name=seed value=0>
<label><input type=checkbox name=sampling> sampling</label>
<label><input type=checkbox name=mc> marching cubes</label><br>
<input type=submit value=Generate>
</form>"""


def _make_handler(engine: ServingEngine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/health":
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"ok")
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_FORM)

        def _error(self, status, exc):
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(json.dumps(
                {"error": f"{type(exc).__name__}: {exc}"}).encode())

        def do_POST(self):
            if self.path != "/generate":
                self.send_response(404)
                self.end_headers()
                return
            # request parsing/validation: malformed inputs (bad base64,
            # unparseable OBJ, oversized completion prompt) are CLIENT
            # errors -> 400 with the validation message; anything that
            # fails past this block is a server fault -> 500
            try:
                import binascii
                import struct

                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                seed = int(self.headers.get("X-Seed", "0"))
                sampling = self.headers.get("X-Sampling", "0") == "1"
                mc = self.headers.get("X-MC", "0") == "1"
                want_json = "application/json" in (self.headers.get("Accept") or "")
                # mesh completion: base64 OBJ of a partial mesh in the
                # SAME coordinate space as the uploaded mesh; its faces
                # seed the decoder
                partial_b64 = self.headers.get("X-Partial-Obj-B64")

                # body is a raw OBJ (API mode). multipart form uploads also
                # land here; extract the file part if present.
                if b"Content-Disposition" in body[:2048]:
                    marker = body.split(b"\r\n")[0]
                    parts = body.split(marker)
                    for part in parts:
                        if b"filename=" in part:
                            body = part.split(b"\r\n\r\n", 1)[1].rsplit(b"\r\n", 1)[0]
                            break

                # sniff the format: the body is raw bytes with no
                # filename, and the loaders key off the extension
                fmt = detect_mesh_format(body)
                with tempfile.NamedTemporaryFile(suffix=f".{fmt}", delete=False) as fh:
                    fh.write(body)
                    path = fh.name
                try:
                    mesh = load_mesh(path)
                finally:
                    os.unlink(path)
                partial_faces = None
                if partial_b64:
                    with tempfile.NamedTemporaryFile(suffix=".obj", delete=False) as fh:
                        fh.write(base64.b64decode(partial_b64, validate=True))
                        ppath = fh.name
                    try:
                        pmesh = load_mesh(ppath)
                    finally:
                        os.unlink(ppath)
                    partial_faces = pmesh.vertices[pmesh.faces]
                    # an oversized partial raises ValueError from
                    # build_face_prompt inside the engine, which the
                    # ValueError->400 branch below maps for the client
            except (binascii.Error, ValueError, KeyError, IndexError,
                    struct.error) as e:
                # struct.error: truncated binary formats (GLB/STL/PLY)
                # raise it from the loaders — still a client error
                self._error(400, e)
                return
            try:
                # renders run OFF the request thread (rasterizing the two
                # previews is host work the reply need not wait for);
                # X-Renders: 0 disables them entirely. JSON mode inlines
                # the PNGs, so it joins the render thread first.
                want_renders = self.headers.get("X-Renders", "1") != "0"
                result = engine.generate_from_mesh(
                    mesh.vertices, mesh.faces,
                    seed=seed, do_sampling=sampling, do_marching_cubes=mc,
                    partial_faces=partial_faces,
                    render="async" if want_renders else "off",
                )

                def read_text(p):
                    with open(p) as fh2:
                        return fh2.read()

                def read_b64(p):
                    with open(p, "rb") as fh2:
                        return base64.b64encode(fh2.read()).decode()

                if want_json:
                    # the reference do_inference's four outputs (app.py:172)
                    payload = {
                        "output_obj": read_text(result["output_obj_path"]),
                        "input_obj": read_text(result["input_obj_path"]),
                        "faces_generated": result["faces_generated"],
                        "faces_final": result["faces_final"],
                        "latency_s": result["latency_s"],
                        "capture_s": result["capture_s"],
                        "artifact_export_s": result["artifact_export_s"],
                    }
                    if want_renders:
                        result["render_thread"].join()
                        payload["output_render_png_b64"] = read_b64(result["output_render_path"])
                        payload["input_render_png_b64"] = read_b64(result["input_render_path"])
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(json.dumps(payload).encode())
                    return

                obj_text = read_text(result["output_obj_path"])
                self.send_response(200)
                self.send_header("Content-Type", "model/obj")
                self.send_header("X-Faces-Generated", str(result["faces_generated"]))
                self.send_header("X-Faces-Final", str(result["faces_final"]))
                self.send_header("X-Latency-S", f"{result['latency_s']:.3f}")
                self.send_header("X-Capture-S", f"{result['capture_s']:.3f}")
                self.send_header("X-Input-Obj", result["input_obj_path"])
                if want_renders:
                    # paths are final but the PNGs are written by a
                    # background thread — X-Renders-Async makes the
                    # eventual-consistency contract explicit to clients
                    # that read the files directly
                    self.send_header("X-Input-Render", result["input_render_path"])
                    self.send_header("X-Output-Render", result["output_render_path"])
                    self.send_header("X-Renders-Async", "1")
                self.end_headers()
                self.wfile.write(obj_text.encode())
            except ValueError as e:
                # validation raised inside the engine (e.g. non-unit
                # normals, oversized prompt) — still a client error
                self._error(400, e)
            except Exception as e:  # genuine server fault
                self._error(500, e)

    return Handler


def serve_http(engine: ServingEngine, host: str = "127.0.0.1", port: int = 7860, *,
               ready: Optional[Callable[[ThreadingHTTPServer], None]] = None) -> None:
    """Serve ``engine`` over HTTP until the server is shut down, then close
    the server and the engine. ``ready(server)`` is called once the socket
    is bound (port 0 picks a free port: ``server.server_address``); a
    caller serving from a thread stops it with ``server.shutdown()``."""
    server = ThreadingHTTPServer((host, port), _make_handler(engine))
    bound_host, bound_port = server.server_address[:2]
    print(f"MeshAnything (PyTorch) serving on http://{bound_host}:{bound_port}", flush=True)
    try:
        if ready is not None:
            ready(server)
        server.serve_forever()
    finally:
        server.server_close()
        engine.close()  # stops the micro-batcher worker if enabled


def serve_gradio(engine: ServingEngine, examples_dir: str | None = None, **launch_kwargs):
    """Gradio Blocks UI mirroring the reference app (app.py:217-269):
    processed-input + generated OBJ viewers, wireframe renders of both,
    MC/sampling/seed controls, and an examples gallery."""
    import gradio as gr

    def do_inference(input_3d, sample_seed=0, do_sampling=False, do_marching_cubes=False):
        mesh = load_mesh(input_3d)
        result = engine.generate_from_mesh(
            mesh.vertices, mesh.faces,
            seed=int(sample_seed), do_sampling=do_sampling,
            do_marching_cubes=do_marching_cubes,
        )
        return (result["input_obj_path"], result["input_render_path"],
                result["output_obj_path"], result["output_render_path"])

    if examples_dir is None and os.path.isdir("examples"):
        examples_dir = "examples"

    with gr.Blocks() as demo:
        gr.Markdown(
            "# MeshAnything (PyTorch)\n"
            "Point-cloud-conditioned artist-mesh generation. "
            "Upload a mesh; it is normalized to a unit bounding box "
            "(+Y up works best). Enable marching-cubes preprocessing for "
            "manually-modeled inputs. The model caps generation at "
            f"{engine.cfg.n_max_triangles} faces."
        )
        with gr.Row(variant="panel"):
            with gr.Column():
                input_3d = gr.Model3D(label="Input Mesh", clear_color=[1, 1, 1, 1])
                with gr.Group():
                    mc = gr.Checkbox(label="Preprocess with Marching Cubes", value=False)
                    sampling = gr.Checkbox(label="Random Sampling", value=False)
                    seed = gr.Number(value=0, label="Seed Value", precision=0)
                submit = gr.Button("Generate", variant="primary")
                if examples_dir and os.path.isdir(examples_dir):
                    example_files = [
                        os.path.join(examples_dir, n)
                        for n in sorted(os.listdir(examples_dir))
                    ]
                else:
                    example_files = []
            with gr.Column():
                input_image_render = gr.Image(label="Wireframe Render of Processed Input Mesh")
                preprocess_model_obj = gr.Model3D(
                    label="Processed Input Mesh (OBJ Format)", clear_color=[1, 1, 1, 1])
                output_image_render = gr.Image(label="Wireframe Render of Generated Mesh")
                output_model_obj = gr.Model3D(
                    label="Generated Mesh (OBJ Format)", clear_color=[1, 1, 1, 1])
                gr.Markdown("Try random sampling with different seed values "
                            "if the result is unsatisfying.")
        outputs = [preprocess_model_obj, input_image_render,
                   output_model_obj, output_image_render]
        if example_files:
            gr.Examples(examples=example_files, inputs=input_3d, outputs=outputs,
                        fn=do_inference, cache_examples=False, examples_per_page=10)
        submit.click(fn=do_inference, inputs=[input_3d, seed, sampling, mc],
                     outputs=outputs)
    demo.launch(**launch_kwargs)


def main(argv=None):
    """The CLI's flags (``cli.get_args``, ``--fast`` and ``--device``
    included; ``--batchsize_per_gpu`` is the micro-batcher's largest
    batch), then the gradio UI where gradio imports, else the HTTP
    server."""
    from meshanything_tpu_torch.cli import (
        build_config,
        check_ported,
        get_args,
        load_params,
        resolve_device,
    )
    from meshanything_tpu_torch.runtime.compile_cache import enable as enable_compile_cache

    enable_compile_cache()
    args = get_args(argv)
    check_ported(args)
    if args.multihost:
        # the CLI's folder-run flag. JAX's server parses --multihost and never
        # reads it, and has no router: replicas behind one are not ported
        raise NotImplementedError("--multihost in serving: not ported yet (the server runs "
                                  "one process; --multihost is the CLI's folder run)")
    device = resolve_device(args.device)
    cfg = build_config(args)
    model = load_params(args, cfg, device)
    # --fast resolves to wq + pallas_int8 + lookahead 8 in get_args
    # (cli.apply_fast_preset): the single-request serving preset
    engine = ServingEngine(model, cfg, bucket=args.bucket, attn=args.attn,
                           lookahead=args.lookahead, wq=args.wq, aot_dir=args.aot_dir,
                           batching=args.batchsize_per_gpu)
    if args.precompile:
        t0 = time.time()
        reports = engine.precompile()
        print(f"precompile done in {time.time() - t0:.1f}s: batch sizes {engine.batch_sizes}, "
              f"{sum(r['graph_captures'] for r in reports)} decode graphs captured")
    try:
        import gradio  # noqa: F401
    except ImportError:
        serve_http(engine)
        return
    serve_gradio(engine, share=False)


if __name__ == "__main__":
    main()
