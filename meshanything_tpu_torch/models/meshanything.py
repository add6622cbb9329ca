"""Top-level MeshAnything composition (the port of
``meshanything_tpu/models/meshanything.py``): perceiver -> condition ->
autoregressive decode -> codebook gather -> noise-resistant detokenizer.

Over a (data, model) mesh (``parallel/mesh.py``) ``generate`` and
``forward_logits`` take the rank's local module (``shard_params``) and the
global batch: each data rank runs its rows, and the rows are gathered
again at the end (the counterpart of the JAX package's jit over
``P("data", ...)``). The model axis is the local module's own.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from meshanything_tpu_torch.config import MeshAnythingConfig
from meshanything_tpu_torch.models import lookahead as la_mod
from meshanything_tpu_torch.models import moonlight as moon_mod
from meshanything_tpu_torch.models import nrd as nrd_mod
from meshanything_tpu_torch.models import perceiver as per_mod
from meshanything_tpu_torch.models import shape_opt as opt_mod
from meshanything_tpu_torch.models.layers import lin
from meshanything_tpu_torch.parallel.collectives import gather_rows


def decoder_module(cfg: MeshAnythingConfig):
    """The module of the configuration's shape decoder: ``shape_opt``
    (OPT) or ``moonlight``. Each gives its ``Decoder`` (the weights),
    ``init_decode_state``, ``decode_segment``, ``decode_loop`` and
    ``generate``, and what the runner asks of it: ``check_tier`` (raises
    for a tier it has not), ``libraries``, ``quantize_layers`` (``wq``),
    ``cache_bytes``, ``prefill_elems`` and ``wq_sizes`` (the memory
    budget)."""
    return {"opt": opt_mod, "moonlight": moon_mod}[cfg.decoder]


class MeshAnything(nn.Module):
    """All weights of the model, one attribute per subtree of the JAX
    parameter tree (``init_meshanything_params``). ``opt`` is the shape
    decoder, OPT's (``ShapeOPT``) or, for a ``MoonlightConfig``,
    ``moonlight.MoonlightDecoder``."""

    def __init__(self, cfg: MeshAnythingConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        self.perceiver = per_mod.Perceiver(cfg.perceiver, **f)
        self.opt = decoder_module(cfg).Decoder(cfg.opt, **f)
        self.nrd = nrd_mod.NRD(cfg.nrd, **f)
        self.cond_head_proj = nn.Linear(cfg.opt.cond_dim, cfg.opt.hidden_size, **f)
        self.cond_proj = nn.Linear(cfg.opt.cond_dim * 2, cfg.opt.hidden_size, **f)


def process_point_feature(m: MeshAnything, cfg: MeshAnythingConfig,
                          point_feature: torch.Tensor) -> torch.Tensor:
    """Condition builder (meshanything.py:125-132): token 0 from the shape
    embed, tokens 1.. from [latents || VAE-decoded latents]."""
    head = lin(point_feature[:, :1], m.cond_head_proj)
    shape_latents = per_mod.to_shape_latents(m.perceiver, cfg.perceiver, point_feature[:, 1:])
    rest = lin(torch.cat([point_feature[:, 1:], shape_latents], dim=-1), m.cond_proj)
    return torch.cat([head, rest], dim=1)


def get_codes(m: MeshAnything, cfg: MeshAnythingConfig, indices: torch.Tensor) -> torch.Tensor:
    """Codebook gather + residual-quantizer sum (meshanything.py:178-212):
    (B, T) ids with pad -1 -> (B, T/3, codebook_dim). An id past the
    codebook takes its last row, as JAX's gather clamps (a completion
    prompt's coordinate ids reach 127, past a small test codebook)."""
    b, t = indices.shape
    idx = indices.reshape(b, t // cfg.num_quantizers, cfg.num_quantizers)
    mask = idx == -1
    codes = m.opt.codebook[idx.masked_fill(mask, 0).clamp_max(cfg.opt.codebook_size - 1)]
    return codes.masked_fill(mask[..., None], 0.0).sum(dim=2)


def token_postprocess(cfg: MeshAnythingConfig, raw_tokens: torch.Tensor) -> torch.Tensor:
    """Strip the predicted bos and the final slot, map special ids to -1,
    shift the rest down by 3 (meshanything.py:163-172)."""
    out = raw_tokens[:, 1:-1]
    return torch.where(out < 3, -1, out - 3)


class GenerateOutput(NamedTuple):
    face_coords: torch.Tensor   # (B, n_max_triangles, 3, 3) f32, NaN padding
    token_ids: torch.Tensor     # (B, generate_length) raw generated stream
    # what a run reports beside its output (``runtime/phases.py::PhaseRunner``:
    # decode steps, seconds by phase, capture_s; the batcher adds the batch)
    stats: Optional[dict] = None


def encode(m: MeshAnything, cfg: MeshAnythingConfig, pc_normal: torch.Tensor):
    """Encode phase: (point features, condition embeddings)."""
    point_feature = per_mod.encode_latents(m.perceiver, cfg.perceiver,
                                           pc_normal.to(cfg.activation_dtype))
    return point_feature, process_point_feature(m, cfg, point_feature)


def local_rows(mesh, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The data rank's block of the global batch ``x`` (B, ...): B must
    split evenly over the data axis. ``x`` itself without a mesh."""
    if mesh is None or mesh.data == 1 or x is None:
        return x
    b = x.shape[0]
    if b % mesh.data:
        raise ValueError(f"batch {b} does not split over {mesh.data} data ranks")
    n = b // mesh.data
    return x[mesh.data_index * n:(mesh.data_index + 1) * n]


def forward_logits(m: MeshAnything, cfg: MeshAnythingConfig, pc_normal: torch.Tensor,
                   token_ids: torch.Tensor, *, remat: bool = False,
                   block_q: int = 0, mesh=None) -> torch.Tensor:
    """Teacher-forcing logits (B, C + T, vocab) f32 over [condition ||
    token_ids] (JAX ``forward_logits``): the training pass. ``remat`` and
    ``block_q`` as in ``shape_opt.forward_full``. With ``mesh`` the batch
    is split over its data axis and the logits gathered (no autograd
    through the gather: the sharded trainer takes its rows' logits)."""
    if cfg.decoder != "opt":
        raise NotImplementedError(f"the {cfg.decoder} decoder has no training pass")
    if mesh is not None and mesh.data > 1:
        logits = forward_logits(m, cfg, local_rows(mesh, pc_normal), local_rows(mesh, token_ids),
                                remat=remat, block_q=block_q)
        return gather_rows(logits, mesh.data_group)
    _, cond = encode(m, cfg, pc_normal)
    return opt_mod.forward_full(m.opt, cfg.opt, cond, token_ids, remat=remat, block_q=block_q)


def detokenize(m: MeshAnything, cfg: MeshAnythingConfig, raw_tokens: torch.Tensor,
               point_feature: torch.Tensor) -> torch.Tensor:
    """Detok phase: raw token stream -> (B, n_max_triangles, 3, 3) coords."""
    ids = token_postprocess(cfg, raw_tokens)
    codes = get_codes(m, cfg, ids).to(cfg.activation_dtype)
    return nrd_mod.decode_faces(m.nrd, cfg.nrd, ids, codes, point_feature)


def generate(m: MeshAnything, cfg: MeshAnythingConfig, pc_normal: torch.Tensor, *,
             sampling: bool = False, generator: Optional[torch.Generator] = None,
             bucket: int = 512, attn: str = "pallas", lookahead: int = 0,
             wq: bool = False, prompt_ids: Optional[torch.Tensor] = None, mesh=None,
             graph: bool = True) -> GenerateOutput:
    """Full inference pass (meshanything.py:134-176) on (B, N, 6)
    normalized points+normals. ``lookahead`` > 0 decodes with Jacobi
    windows of that width (``models/lookahead.py``; with ``sampling``,
    speculative sampling); ``attn`` picks the cache tier, or "megakernel"
    for one K5 launch a step (single-token loop only), and ``wq`` the
    int8 layer matrices (``models/shape_opt.py``). ``prompt_ids`` (B, P)
    continues a token prefix (``complete``). ``mesh``: ``m`` is the rank's
    local module and the batch is split over the data axis, the rows
    gathered at the end (a data rank's decode runs no collective; a
    sampled row draws from ``generator`` as the first rows of a batch do).
    ``graph=False``: the eager decode on a card (a tensor-parallel decode
    over gloo must ask for it)."""
    if mesh is not None and mesh.data > 1:
        out = generate(m, cfg, local_rows(mesh, pc_normal), sampling=sampling,
                       generator=generator, bucket=bucket, attn=attn, lookahead=lookahead, wq=wq,
                       prompt_ids=local_rows(mesh, prompt_ids), graph=graph)
        return GenerateOutput(gather_rows(out.face_coords, mesh.data_group),
                              gather_rows(out.token_ids, mesh.data_group))
    point_feature, cond = encode(m, cfg, pc_normal)
    kw = dict(max_new_tokens=cfg.generate_length, sampling=sampling, generator=generator,
              bucket=bucket, attn=attn, wq=wq, prompt_ids=prompt_ids, graph=graph)
    decoder_module(cfg).check_tier(attn, lookahead)
    if lookahead > 0:
        raw = la_mod.generate_lookahead(m.opt, cfg.opt, cond, window=lookahead, **kw)
    else:
        raw = decoder_module(cfg).generate(m.opt, cfg.opt, cond, **kw)
    return GenerateOutput(detokenize(m, cfg, raw, point_feature), raw)


def discretize_faces(cfg: MeshAnythingConfig, face_coords) -> torch.Tensor:
    """Inverse of the NRD undiscretize (meshanything.py:214-223): clamp
    [-0.5, 0.5) coords onto the discrete grid and add the +3 special
    offset -> (B, nf*9) stream-order token ids, int64. The arithmetic is
    f32, as in the JAX package (its arrays are f32 whatever the input)."""
    bins = cfg.nrd.discrete_num
    coords = torch.as_tensor(face_coords, dtype=torch.float32)
    disc = torch.clamp(torch.floor((coords + 0.5) * bins), 0, bins - 1)
    return disc.to(torch.int64).reshape(coords.shape[0], -1) + 3


def build_face_prompt(cfg: MeshAnythingConfig, face_coords) -> torch.Tensor:
    """The prompt of mesh completion, shared by ``complete``, the CLI and
    serving: [bos || discretize_faces] in stream order, (B, 1 + nf*9)
    int64. ``face_coords`` (B, nf, 3, 3). A partial mesh that leaves the
    decoder no room to continue raises ValueError up front."""
    coords = torch.as_tensor(face_coords)
    nf = coords.shape[1]
    max_nf = (cfg.generate_length - 2) // cfg.opt.face_per_token
    if nf >= max_nf:
        raise ValueError(
            f"partial mesh has {nf} faces; completion needs room to "
            f"continue — at n_max_triangles={cfg.n_max_triangles} the "
            f"prompt may carry at most {max_nf - 1} faces")
    toks = discretize_faces(cfg, coords)
    bos = torch.full((coords.shape[0], 1), cfg.opt.bos_token_id, dtype=torch.int64)
    return torch.cat([bos, toks], dim=1)


def complete(m: MeshAnything, cfg: MeshAnythingConfig, pc_normal: torch.Tensor,
             partial_faces, *, sampling: bool = False,
             generator: Optional[torch.Generator] = None, bucket: int = 512,
             attn: str = "pallas", lookahead: int = 0, wq: bool = False) -> GenerateOutput:
    """Mesh completion (JAX ``meshanything.py:164``): continue the
    generation from a partial face list conditioned on the whole shape's
    point cloud. ``partial_faces`` (B, nf, 3, 3) in [-0.5, 0.5) are
    discretized onto the token grid, prefilled as [bos || face tokens] in
    one causal pass, and decoded on from there; the prompt faces come
    back at the front of the output stream."""
    prompt = build_face_prompt(cfg, partial_faces).to(pc_normal.device)
    return generate(m, cfg, pc_normal, sampling=sampling, generator=generator, bucket=bucket,
                    attn=attn, lookahead=lookahead, wq=wq, prompt_ids=prompt)
