"""Synthetic artist-mesh token grammar (the port of
``meshanything_tpu/training/synthetic_grammar.py``; the mesh and batch
builders are numpy copies, bit-equal to JAX's for the same rng).

Real MeshAnything token streams are highly structured: 9 tokens per
face, coordinates discretized to 128 bins, and adjacent faces in the
serialization share most of their vertices (measured here: a grid mesh
shares ~4.5 of 9 tokens with the previous face). Lookahead (Jacobi)
decoding exploits exactly this structure, but its acceptance rate
cannot be measured with random weights (random-weight greedy
degenerates to repeats — the acceptance best case, VERDICT r1).

This module generates procedural meshes with the real serialization
structure, builds teacher-forcing batches from them through the actual
pipeline (surface sampling included), and is used to (a) train a small
decoder to emit the grammar and (b) measure lookahead acceptance on the
trained model — a defensible bound for realistic acceptance until real
weights are available (no network egress in this environment).
"""
from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Optional, Tuple

import numpy as np
import torch


from meshanything_tpu_torch.config import MeshAnythingConfig
from meshanything_tpu_torch.geometry.sample import sample_surface_with_normals
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import perceiver as per_mod
from meshanything_tpu_torch.models.lookahead import generate_lookahead
from meshanything_tpu_torch.runtime.checkpoint import jax_numpy_from_params, params_from_jax_numpy


def _log(msg: str) -> None:
    # diagnostics go to stderr: the probe's stdout carries its results
    print(msg, file=sys.stderr, flush=True)


def grid_mesh(rng: np.random.Generator, k: int = 5, smooth: int = 2,
              jitter: float = 0.0):
    """A (k x k) height-field terrain: the canonical structured artist
    mesh (shared vertices between adjacent faces).

    jitter > 0 perturbs every vertex coordinate with Gaussian noise of
    that scale AFTER smoothing — each draw then has unique, unmemorizable
    coordinates while the face/topology grammar stays fixed (the
    higher-entropy training task of VERDICT r4 #7)."""
    xs = np.linspace(-0.4, 0.4, k)
    zs = np.linspace(-0.4, 0.4, k)
    h = rng.normal(size=(k, k)) * 0.1
    for _ in range(smooth):
        h = 0.25 * (np.roll(h, 1, 0) + np.roll(h, -1, 0)
                    + np.roll(h, 1, 1) + np.roll(h, -1, 1))
    vertices = np.array([[xs[i], h[i, j], zs[j]] for i in range(k) for j in range(k)])
    if jitter > 0:
        vertices = vertices + rng.normal(size=vertices.shape) * jitter
    faces = []
    for i in range(k - 1):
        for j in range(k - 1):
            a = i * k + j
            faces.append([a, a + 1, a + k])
            faces.append([a + 1, a + k + 1, a + k])
    return vertices, np.asarray(faces, np.int64)


_CHAIN_PERM_SEED = 1234567


def _chain_perm(lo: int, hi: int) -> np.ndarray:
    """The fixed pseudo-random bin permutation that defines the chain
    grammar's height transitions (a grammar RULE, so it is shared by
    every mesh and every batch — the model has to learn the table)."""
    return np.random.default_rng(_CHAIN_PERM_SEED).permutation(
        np.arange(lo, hi))


def chain_grid_mesh(rng: np.random.Generator, k: int = 5, bins: int = 128,
                    per_mesh_perm: bool = False):
    """The chain grammar (VERDICT r4 #7): a (k x k) grid whose vertex
    heights follow a fixed pseudo-random permutation orbit in BIN space
    — bin(next new vertex) = PERM[bin(previous new vertex)] in stream
    first-appearance order, start bin drawn per mesh — while the point
    cloud is built from the FLAT base grid.

    Why: the noisy-jitter variant failed to lower natural Jacobi
    acceptance (measured 7.904, PERF.md r5) because the point-cloud
    condition fully determines every coordinate, so greedy argmax is
    condition-driven and stable under stale in-window context. Here the
    heights exist ONLY in the token stream (the condition is a flat
    plane): each new-vertex height token's argmax is a function of the
    PREVIOUS height token ~9-18 positions back, so a stale Jacobi guess
    upstream genuinely flips downstream predictions — mispredict
    recovery becomes a measurement instead of a max_accept simulation.

    Returns (v_tokens, v_pc, faces): v_tokens carries the walk (token
    stream source), v_pc is the flat grid (condition source). Heights
    are placed at exact bin centers so discretization is lossless.

    per_mesh_perm: draw the permutation fresh per mesh (from rng)
    instead of the fixed grammar rule. MEASURED r5: the fixed orbit
    FAILED to lower 350M acceptance (7.904 — with a single global
    permutation the model learns the composed maps PERM^n and predicts
    window position i from pre-window context alone, so stale in-window
    guesses never flip an argmax; the small CPU config, which cannot
    memorize the composed tables, measured 4.31). A per-mesh permutation
    removes the memorizable rule entirely — and MEASURED r5, the 350M
    STILL saturates at 7.904: an unlearnable transition trains a ~flat
    conditional whose argmax is a constant marginal mode, which is just
    as Jacobi-stable as a memorized one. (The CPU prototype's 4.38 came
    from an under-trained model with noisy conditionals.) Conclusion
    recorded in PERF.md r5: converged greedy models are Jacobi-saturated
    on both learnable AND unlearnable synthetic grammars; the honest low
    band stays the max_accept cap."""
    xs = np.linspace(-0.4, 0.4, k)
    zs = np.linspace(-0.4, 0.4, k)
    base = np.array([[xs[i], 0.0, zs[j]] for i in range(k) for j in range(k)])
    faces = []
    for i in range(k - 1):
        for j in range(k - 1):
            a = i * k + j
            faces.append([a, a + 1, a + k])
            faces.append([a + 1, a + k + 1, a + k])
    faces = np.asarray(faces, np.int64)

    # keep the walk inside the grid's coordinate envelope (|y| <= ~.36)
    lo, hi = int(round(0.15 * bins)), int(round(0.85 * bins))
    if per_mesh_perm:
        perm = rng.permutation(np.arange(lo, hi))
    else:
        perm = _chain_perm(lo, hi)

    # first-appearance order in the face serialization: the chain is a
    # STREAM-local dependency (each new height token depends on the one
    # that last appeared), which is what Jacobi windows break
    order, seen = [], set()
    for f in faces:
        for vid in f:
            if vid not in seen:
                seen.add(vid)
                order.append(int(vid))

    vbins = np.empty(k * k, np.int64)
    b = int(rng.integers(lo, hi))
    for vid in order:
        vbins[vid] = b
        b = int(perm[b - lo])

    v_tokens = base.copy()
    v_tokens[:, 1] = (vbins + 0.5) / bins - 0.5
    return v_tokens, base, faces


def mesh_to_token_stream(vertices: np.ndarray, faces: np.ndarray,
                         bins: int = 128) -> np.ndarray:
    """Discretize + serialize like the real data: 9 tokens per face
    (3 vertices x 3 coords, meshanything.py:214-223 inverse), +3 special
    offset."""
    disc = np.clip(((vertices + 0.5) * bins).astype(np.int64), 0, bins - 1)
    return (disc[faces].reshape(-1) + 3).astype(np.int32)


def make_grammar_batch(cfg: MeshAnythingConfig, rng: np.random.Generator,
                       batch: int, k: int = 5,
                       mask_padding: bool = False,
                       jitter: float = 0.0,
                       chain=False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Teacher-forcing batch over synthetic meshes: real surface-sampled
    point clouds as conditions, [bos, face tokens..., eos] streams
    padded with eos to generate_length.

    mask_padding: label the eos padding tail (everything after the first
    eos) with -100. Without it ~2/3 of the loss mass is trivially
    learnable eos, which dilutes the coordinate gradient — measured at
    350M the optimizer then settles into a structure-only attractor
    (content at near-uniform 4.4 nats, total 1.42) whose greedy decode
    emits eos immediately.

    chain: use the chain grammar (chain_grid_mesh) — token streams from
    the permutation-walked mesh, point clouds from the flat base grid
    (bins capped so the walk never hits the vocab clip below)."""
    seq = cfg.generate_length
    bins = cfg.nrd.discrete_num
    if chain:
        bins = min(bins, cfg.opt.vocab_size - 4)
    pcs, streams, lengths = [], [], []
    for _ in range(batch):
        if chain:
            v, v_pc, f = chain_grid_mesh(rng, k=k, bins=bins,
                                         per_mesh_perm=chain == "rand")
        else:
            v, f = grid_mesh(rng, k=k, jitter=jitter)
            v_pc = v
        toks = mesh_to_token_stream(v, f, bins)
        # clip vocab for small test configs
        toks = np.minimum(toks, cfg.opt.vocab_size - 1)
        stream = np.full((seq,), cfg.opt.eos_token_id, np.int32)
        stream[0] = cfg.opt.bos_token_id
        n = min(len(toks), seq - 2)
        stream[1:1 + n] = toks[:n]
        streams.append(stream)
        lengths.append(1 + n + 1)  # bos + content + one labeled eos
        pcs.append(sample_surface_with_normals(v_pc, f, cfg.perceiver.num_points, rng))
    pc = np.stack(pcs).astype(np.float32)
    ids = np.stack(streams)
    labels = np.full((batch, cfg.cond_length + seq), -100, np.int32)
    labels[:, cfg.cond_length:] = ids
    if mask_padding:
        for row, n in enumerate(lengths):
            labels[row, cfg.cond_length + n:] = -100
    return pc, ids, labels


def train_on_grammar(cfg: MeshAnythingConfig, steps: int = 200, batch: int = 8,
                     k: int = 5, seed: int = 0, lr: float = 3e-3,
                     refresh_every: int = 0, verbose: bool = False,
                     mask_padding: bool = False, jitter: float = 0.0,
                     chain=False, *, device="cuda"):
    """Train a MeshAnything decoder on the grammar from seeded f32
    weights; returns (model, final loss).

    refresh_every > 0 draws a fresh batch of procedural meshes every N
    steps (structural generalization instead of batch memorization); 0
    keeps one fixed batch. k may be an int or a (lo, hi) range sampled per
    refresh. The loop is ``training/train.py::run_training`` with the
    clip + warmup-cosine recipe over ``steps``: without the clip the
    fast-learning regime (lr >= 2e-4 at 350M) explodes after ~50 steps,
    and with an lr low enough to stay stable it sits in the unigram
    plateau (~3.0), as the JAX package measured."""
    from meshanything_tpu_torch.training.optim import make_optimizer
    from meshanything_tpu_torch.training.train import run_training

    rng = np.random.default_rng(seed)

    def draw():
        kk = k if isinstance(k, int) else int(rng.integers(k[0], k[1] + 1))
        return make_grammar_batch(cfg, rng, batch, k=kk, mask_padding=mask_padding,
                                  jitter=jitter, chain=chain)

    def batches():
        current = draw()
        for i in range(steps):
            if refresh_every and i and i % refresh_every == 0:
                current = draw()
            yield current

    last = {}

    def record(n, metrics):
        last["loss"] = metrics["loss"]

    state = run_training(cfg, batches(), steps=steps, device=device, seed=seed,
                         optimizer=make_optimizer(lr, steps=steps),
                         log_every=25 if verbose else 0, on_metrics=record)
    return state.model, float(last.get("loss", float("nan")))


@torch.no_grad()
def measure_lookahead_acceptance(model, cfg: MeshAnythingConfig, pc: np.ndarray,
                                 window: int = 8, bucket: int = 32, attn: str = "pallas",
                                 max_accept: Optional[int] = None) -> dict:
    """Run plain greedy and lookahead decoding on the same conditions;
    return the acceptance (tokens per row per window forward), the
    forwards, the tokens emitted, and the agreement with plain greedy
    through each plain row's first eos. ``max_accept`` caps the tokens a
    forward accepts (``models/lookahead.py``), which keeps the stream.
    The activations follow the weights' dtype."""
    dtype = model.opt.cond_embed.dtype
    device = model.opt.cond_embed.device
    pcj = torch.as_tensor(np.asarray(pc), device=device).to(dtype)
    pf = per_mod.encode_latents(model.perceiver, cfg.perceiver, pcj)
    cond = ma.process_point_feature(model, cfg, pf)

    plain = decoding.generate(model.opt, cfg.opt, cond, max_new_tokens=cfg.generate_length,
                              bucket=bucket, attn=attn).cpu().numpy()
    look, stats = generate_lookahead(model.opt, cfg.opt, cond,
                                     max_new_tokens=cfg.generate_length, window=window,
                                     bucket=bucket, attn=attn, return_stats=True,
                                     max_accept=max_accept)
    look = look.cpu().numpy()

    emitted = int((stats["emitted"] - 1).sum())    # the prefill emits token 0
    iters = max(int(stats["iterations"]), 1)
    b = plain.shape[0]
    agree, total = 0, 0
    for row in range(b):
        eos = np.where(plain[row] == cfg.opt.eos_token_id)[0]
        limit = (eos[0] + 1) if len(eos) else plain.shape[1]
        agree += int((look[row, :limit] == plain[row, :limit]).sum())
        total += int(limit)
    return {
        # iterations count batch-level forwards, so divide by B: rows
        # frozen at eos add 0 to the later forwards (a mild lower bound on
        # the per-row acceptance, exact when the rows finish together)
        "acceptance": emitted / (iters * b),
        "iterations": iters,
        "emitted": emitted,
        "agreement": agree / max(total, 1),
        "plain_tokens": total,
    }


def _flatten_tree(tree, prefix=""):
    """Nested dict of arrays -> flat {'a/b/c': np.ndarray} (npz-safe)."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten_tree(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _unflatten_tree(flat):
    out = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return out


def get_trained_350m(steps: int = 600, batch: int = 4, n_max_triangles: int = 100,
                     lr: float = 1e-3, seed: int = 0, cache: Optional[str] = None,
                     device="cuda"):
    """Load or train the full 350M architecture on the face grammar;
    returns (bf16 model, cfg). ``cache`` (default the GRAMMAR_PROBE_CACHE
    variable, else a file in the temp directory keyed by the training
    knobs) holds the trained f32 weights as a flat npz in the JAX
    package's layout and key names (``jax_numpy_from_params``), so one
    cache file serves both packages. The recipe is the JAX package's: a
    fixed batch of k=5 grids with mask_padding (at 350M the dense k=8
    task sits in the unigram plateau for every lr tried, and without
    mask_padding the optimizer settles where greedy emits eos at once)."""
    cfg = MeshAnythingConfig(n_max_triangles=n_max_triangles)
    t0 = time.time()
    if cache is None:
        default = os.path.join(tempfile.gettempdir(), f"grammar350m_s{steps}b{batch}"
                               f"n{n_max_triangles}lr{lr:g}seed{seed}.npz")
        cache = os.environ.get("GRAMMAR_PROBE_CACHE", default)
    if cache and os.path.exists(cache):
        with np.load(cache) as flat:
            model = params_from_jax_numpy(_unflatten_tree(dict(flat)), cfg, device=device)
        _log(f"loaded trained params from {cache}")
    else:
        model, loss = train_on_grammar(cfg, steps=steps, batch=batch, k=5, seed=seed, lr=lr,
                                       verbose=True, mask_padding=True, device=device)
        _log(f"trained 350M on grammar: loss {loss:.4f} in {time.time() - t0:.0f}s")
        if cache:
            np.savez(cache, **_flatten_tree(jax_numpy_from_params(model)))
            _log(f"saved trained params to {cache}")
    return model.to(torch.bfloat16), cfg


def _timed(fn) -> float:
    """Seconds of one call of ``fn`` after one untimed call, the card
    synchronised at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def full_scale_probe(steps: int = 600, batch: int = 4, n_max_triangles: int = 100,
                     lr: float = 1e-3, window: int = 8, seed: int = 0, device="cuda"):
    """Train the full 350M architecture on the grammar on the card, then
    measure lookahead acceptance and wall-clock with the trained weights
    (``python -m meshanything_tpu_torch.training.synthetic_grammar``).
    Decodes with the exact tier (K1; lookahead: the bf16 K4) at bucket
    512 through the graph-replayed ``generate`` / ``generate_lookahead``;
    each timed call includes its graph's capture. Returns ({"train-cond":
    stats, "heldout-cond": stats}, plain s, lookahead s), the times on the
    training conditions."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("full_scale_probe decodes through the CUDA kernels: it needs a card")
    model, cfg = get_trained_350m(steps=steps, batch=batch, n_max_triangles=n_max_triangles,
                                  lr=lr, seed=seed, device=device)
    # on-distribution conditions: the training batch's (greedy replays the
    # learned streams) and held-out k=5 meshes; other sizes make the model
    # emit eos at once, which measures nothing
    train_pc, _, _ = make_grammar_batch(cfg, np.random.default_rng(seed), 2, k=5)
    held_pc, _, _ = make_grammar_batch(cfg, np.random.default_rng(seed + 99), 2, k=5)

    stats = {}
    for label, pc in (("train-cond", train_pc), ("heldout-cond", held_pc)):
        s = stats[label] = measure_lookahead_acceptance(model, cfg, pc, window=window,
                                                        bucket=512, attn="pallas")
        print(f"{label}: acceptance {s['acceptance']:.2f} tokens/row/forward "
              f"(window {window}, {s['plain_tokens']} plain tokens); "
              f"agreement vs plain greedy: {s['agreement']:.4f}", flush=True)

    with torch.no_grad():
        pcj = torch.as_tensor(train_pc, device=device).to(torch.bfloat16)
        cond = ma.process_point_feature(
            model, cfg, per_mod.encode_latents(model.perceiver, cfg.perceiver, pcj))
        gl = cfg.generate_length
        t_plain = _timed(lambda: decoding.generate(model.opt, cfg.opt, cond, max_new_tokens=gl,
                                                   bucket=512, attn="pallas"))
        t_look = _timed(lambda: generate_lookahead(model.opt, cfg.opt, cond, max_new_tokens=gl,
                                                   window=window, bucket=512, attn="pallas"))
    print(f"plain greedy: {t_plain:.3f}s", flush=True)
    print(f"lookahead W={window}: {t_look:.3f}s", flush=True)
    print(f"trained-weights lookahead speedup: {t_plain / t_look:.2f}x", flush=True)
    return stats, t_plain, t_look


if __name__ == "__main__":
    full_scale_probe()
