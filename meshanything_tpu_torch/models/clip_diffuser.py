"""ClipASLDiffuser — CLIP-conditioned latent diffusion over shape latents,
composed end to end: the port of ``meshanything_tpu/models/clip_diffuser.py``
(the reference's clip_asl_diffuser_pl_module.py).

  train:  surface -> perceiver.encode_latents -> KL sample
          -> diffusion_loss(latents, CLIP image condition)  (:241-301)
  sample: image/text -> CLIP -> ddim_sample(latents)
          -> perceiver.decode_latents -> extract_geometry    (:315-380)

The CLIP towers and the perceiver are frozen (``requires_grad_(False)``
in ``clip_diffuser_loss``): autograd reaches the denoiser's parameters
alone. Marching runs on the host (``runtime/recon.py``)."""
from __future__ import annotations

from typing import List, Optional

import torch

from meshanything_tpu_torch.config import PerceiverConfig
from meshanything_tpu_torch.models import clip_cond as cc
from meshanything_tpu_torch.models import diffusion as dm
from meshanything_tpu_torch.models import perceiver as per_mod
from meshanything_tpu_torch.models.perceiver import Perceiver


def encode_first_stage(perceiver: Perceiver, pcfg: PerceiverConfig, surface: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """surface (B, N, 6) -> KL latents (B, num_latents, embed_dim)
    (clip_asl_diffuser_pl_module.py:229-236): a posterior sample drawn
    from ``generator`` when one is given, the mode otherwise."""
    latents = per_mod.encode_latents(perceiver, pcfg, surface)[:, 1:]   # drop the shape token
    if generator is None:
        return per_mod.encode_kl_mode(perceiver, latents)
    return per_mod.encode_kl_sample(perceiver, latents, generator)


def clip_diffuser_loss(udt: dm.UDTDenoiser, perceiver: Perceiver, pcfg: PerceiverConfig,
                       vision: cc.CLIPVisionTower, surface: torch.Tensor, image: torch.Tensor, *,
                       generator: torch.Generator, cond_drop_prob: float = 0.1) -> torch.Tensor:
    """One evaluation of the training objective: the eps-MSE over KL
    samples of the VAE latents with the frozen CLIP image condition (the
    reference's forward + compute_loss "noise" branch, :241-348). Draws,
    in order: the posterior sample, then the loss's."""
    perceiver.requires_grad_(False)
    vision.requires_grad_(False)
    with torch.no_grad():
        latents = encode_first_stage(perceiver, pcfg, surface, generator)
        cond = cc.image_embedding(vision, image)
    return dm.diffusion_loss(udt, latents, cond, generator=generator,
                             cond_drop_prob=cond_drop_prob)


def sample_latents_from_cond(udt: dm.UDTDenoiser, cond: torch.Tensor, *, num_latents: int,
                             embed_dim: int, steps: int = 50, guidance_scale: float = 3.0,
                             generator: Optional[torch.Generator] = None,
                             x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cond (B, n, ctx_dim) -> sampled KL latents by DDIM + CFG, zeros as
    the unconditional embedding (the MDM convention, :425-430)."""
    return dm.ddim_sample(udt, cond, shape=(num_latents, embed_dim), steps=steps,
                          guidance_scale=guidance_scale, generator=generator, x_T=x_T)


@torch.no_grad()
def _shapes_from_cond(udt, perceiver, pcfg, cond, steps, guidance_scale, octree_depth,
                      generator, x_T) -> List:
    from meshanything_tpu_torch.runtime.recon import extract_geometry

    z = sample_latents_from_cond(udt, cond, num_latents=pcfg.num_latents,
                                 embed_dim=pcfg.embed_dim, steps=steps,
                                 guidance_scale=guidance_scale, generator=generator, x_T=x_T)
    decoded = per_mod.decode_latents(perceiver, pcfg, z.float())
    return extract_geometry(perceiver, pcfg, decoded, octree_depth=octree_depth)


@torch.no_grad()
def sample_shapes_from_image(udt: dm.UDTDenoiser, perceiver: Perceiver, pcfg: PerceiverConfig,
                             vision: cc.CLIPVisionTower, image: torch.Tensor, *,
                             steps: int = 50, guidance_scale: float = 3.0, octree_depth: int = 6,
                             generator: Optional[torch.Generator] = None,
                             x_T: Optional[torch.Tensor] = None) -> List:
    """Image -> shape: CLIP embedding, DDIM over the latents, VAE decode,
    occupancy marching (ClipASLDiffuser.sample, :315-380). A list of
    Mesh | None per batch row. ``x_T``: the DDIM's initial latent, else
    drawn from ``generator``."""
    cond = cc.image_embedding(vision, image)
    return _shapes_from_cond(udt, perceiver, pcfg, cond, steps, guidance_scale, octree_depth,
                             generator, x_T)


@torch.no_grad()
def sample_shapes_from_text(udt: dm.UDTDenoiser, perceiver: Perceiver, pcfg: PerceiverConfig,
                            text: cc.CLIPTextTower, input_ids: torch.Tensor, *,
                            steps: int = 50, guidance_scale: float = 3.0, octree_depth: int = 6,
                            generator: Optional[torch.Generator] = None,
                            x_T: Optional[torch.Tensor] = None) -> List:
    """Tokenized text -> shape: the pooled projected text feature,
    L2-normalized, conditions the denoiser."""
    feats = text.features(input_ids)
    cond = (feats / torch.linalg.norm(feats, dim=-1, keepdim=True))[:, None, :]
    return _shapes_from_cond(udt, perceiver, pcfg, cond, steps, guidance_scale, octree_depth,
                             generator, x_T)
