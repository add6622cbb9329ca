"""Aligned-shape-latent (ASL) diffusion: the port of
``meshanything_tpu/models/diffusion.py`` (the reference's vendored
latent-diffusion tier, asl_diffusion/ and modules/diffusion_transformer.py).

  * ``UDTDenoiser`` — ConditionalASLUDTDenoiser (asl_udt.py:13-102): the
    timestep embedding and MLP, LN + linear context embedding, the input
    projection, [t ‖ context ‖ x] through the U-Net transformer
    (diffusion_transformer.py:135-218: an encoder stack whose outputs are
    the skips, a middle block, a decoder stack that pops each skip in
    reverse through concat + linear + optional LN), ln_post and the
    output projection over the trailing n_data tokens.
  * ``DiTBlock`` — the AdaLN DiT block (diffusion_transformer.py:18-90).
  * ``diffusion_loss`` — eps-prediction MSE with condition dropout
    (asl_diffuser_pl_module.py:322-348).
  * ``ddim_sample`` / ``karras_sample`` — DDIM with classifier-free
    guidance (inference_utils.py:12-76) and Karras/EDM-Heun.

The modules mirror the JAX parameter tree name for name
(``runtime/checkpoint.py::udt_from_jax_numpy``). JAX runs each sampler as
one ``lax.scan``; here it is a Python loop over a schedule computed on the
host before the loop, so no step reads anything back from the device.
Random draws come from an explicit ``torch.Generator``; the samplers also
take the initial latent ``x_T``, and ``diffusion_loss_with`` the loss's
draws, so that a test can hand both packages the same numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from meshanything_tpu_torch.models.layers import (
    SelfAttentionBlock,
    _merge_heads,
    _split_heads,
    attention,
    gelu,
    lin,
    ln,
)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """ASL latent diffusion over the VAE bottleneck (n_ctx latent tokens
    of input_channels dims — shapevae-256: 256 x 64)."""

    input_channels: int = 64
    output_channels: int = 64
    n_ctx: int = 256
    width: int = 768
    layers: int = 6          # encoder depth; total blocks = 2*layers + 1
    heads: int = 12
    context_dim: int = 768
    context_ln: bool = True
    skip_ln: bool = True
    init_scale: float = 0.25
    flip_sin_to_cos: bool = False
    # schedule (scaled-linear, the SD/Michelangelo recipe)
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    ln_eps: float = 1e-5


def small_diffusion_config() -> DiffusionConfig:
    return DiffusionConfig(input_channels=8, output_channels=8, n_ctx=16,
                           width=48, layers=2, heads=4, context_dim=48,
                           num_train_timesteps=100)


# ---------------------------------------------------------------------------
# schedule


def alphas_cumprod(cfg: DiffusionConfig, device=None) -> torch.Tensor:
    """Scaled-linear beta schedule (betas linear in sqrt space), in f32.

    JAX asks for a float64 linspace, which without x64 is f32; so this is
    f32 throughout, with JAX's linspace formula (start·(1 - s) + stop·s).
    XLA fuses and orders the f32 arithmetic its own way, so the values
    agree with JAX's to a few f32 ulps, not bit for bit."""
    n = cfg.num_train_timesteps
    start = torch.tensor(cfg.beta_start ** 0.5, dtype=torch.float32)
    stop = torch.tensor(cfg.beta_end ** 0.5, dtype=torch.float32)
    step = torch.arange(n - 1, dtype=torch.float32) / (n - 1)
    sqrt_betas = torch.cat([start * (1 - step) + stop * step, stop[None]])
    return torch.cumprod(1.0 - sqrt_betas ** 2, 0).to(device)


def add_noise(cfg: DiffusionConfig, latents: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0): sqrt(a_t) x_0 + sqrt(1 - a_t) eps
    (asl_diffuser_pl_module.py:337)."""
    a = alphas_cumprod(cfg, latents.device)[timesteps]
    a = a.reshape(a.shape + (1,) * (latents.ndim - a.ndim))
    return torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise


def timestep_embedding(t: torch.Tensor, dim: int, *, flip_sin_to_cos: bool = False,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """diffusers' Timesteps (asl_udt.py:53): [sin ‖ cos] (or [cos ‖ sin])
    of t·exp(-log(max_period)·i/(half - shift)), zero-padded to an odd
    ``dim``."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        out = F.pad(out, (0, 1))
    return out


# ---------------------------------------------------------------------------
# the U-Net transformer denoiser


class UDTDenoiser(nn.Module):
    """ConditionalASLUDTDenoiser over a UNetDiffusionTransformer
    (``denoise`` of the JAX package is ``forward``)."""

    def __init__(self, cfg: DiffusionConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        w = cfg.width
        self.cfg = cfg

        def block():
            return SelfAttentionBlock(w, cfg.heads, qkv_bias=False, ln_eps=cfg.ln_eps,
                                      dual_sqrt_scale=True, **f)

        self.encoder = nn.ModuleList(block() for _ in range(cfg.layers))
        self.middle = block()
        self.decoder = nn.ModuleList(block() for _ in range(cfg.layers))
        self.skip_proj = nn.ModuleList(nn.Linear(2 * w, w, **f) for _ in range(cfg.layers))
        if cfg.skip_ln:
            self.skip_ln = nn.ModuleList(nn.LayerNorm(w, eps=cfg.ln_eps, **f)
                                         for _ in range(cfg.layers))
        self.ln_post = nn.LayerNorm(w, eps=cfg.ln_eps, **f)
        self.input_proj = nn.Linear(cfg.input_channels, w, **f)
        self.output_proj = nn.Linear(w, cfg.output_channels, **f)
        # time_proj: the michelangelo MLP (w -> 4w GELU -> w)
        self.time_fc = nn.Linear(w, 4 * w, **f)
        self.time_out = nn.Linear(4 * w, w, **f)
        self.context_embed = nn.Linear(cfg.context_dim, w, **f)
        if cfg.context_ln:
            self.context_ln = nn.LayerNorm(cfg.context_dim, eps=cfg.ln_eps, **f)

    def unet(self, x: torch.Tensor) -> torch.Tensor:
        """diffusion_transformer.py:200-218."""
        skips = []
        for block in self.encoder:
            x = block(x)
            skips.append(x)
        x = self.middle(x)
        for i, block in enumerate(self.decoder):
            x = lin(torch.cat([skips.pop(), x], dim=-1), self.skip_proj[i])
            if self.cfg.skip_ln:
                x = ln(x, self.skip_ln[i])
            x = block(x)
        return x

    def forward(self, model_input: torch.Tensor, timestep: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        """asl_udt.py:72-101. model_input (B, n_data, C_in), timestep (B,)
        int, context (B, n_cond, context_dim) -> (B, n_data, C_out)."""
        cfg = self.cfg
        n_data = model_input.shape[1]
        t_emb = timestep_embedding(timestep, cfg.width, flip_sin_to_cos=cfg.flip_sin_to_cos)
        t_emb = lin(gelu(lin(t_emb.to(model_input.dtype), self.time_fc)), self.time_out)
        if cfg.context_ln:
            context = ln(context, self.context_ln)
        context = lin(context, self.context_embed)
        x = torch.cat([t_emb[:, None], context, lin(model_input, self.input_proj)], dim=1)
        x = ln(self.unet(x), self.ln_post)
        return lin(x[:, -n_data:], self.output_proj)


# ---------------------------------------------------------------------------
# AdaLN DiT block (diffusion_transformer.py:18-90) — the alternative backbone


def _ada_ln(x: torch.Tensor, t: torch.Tensor, m: nn.Linear, eps: float) -> torch.Tensor:
    """AdaLayerNorm: LN without affine (population variance, as
    ``jnp.var``), modulated by SiLU(t) -> scale/shift."""
    scale, shift = lin(F.silu(t), m).chunk(2, dim=-1)
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * (1 + scale) + shift


class DiTBlock(nn.Module):
    """DitBlock._forward (diffusion_transformer.py:83-90): AdaLN self-attn,
    optional AdaLN cross-attn (when ``context_dim`` is given), AdaLN MLP —
    all residual."""

    def __init__(self, width: int, num_heads: int, *, context_dim: Optional[int] = None,
                 ln_eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        self.num_heads = num_heads
        self.ln_eps = ln_eps
        self.ada1 = nn.Linear(width, 2 * width, **f)
        self.qkv = nn.Linear(width, 3 * width, bias=False, **f)
        self.attn_out = nn.Linear(width, width, **f)
        self.ada3 = nn.Linear(width, 2 * width, **f)
        self.fc = nn.Linear(width, 4 * width, **f)
        self.fc_out = nn.Linear(4 * width, width, **f)
        self.cross = context_dim is not None
        if self.cross:
            self.ada2 = nn.Linear(width, 2 * width, **f)
            self.cross_q = nn.Linear(width, width, bias=False, **f)
            self.cross_kv = nn.Linear(context_dim, 2 * width, bias=False, **f)
            self.cross_out = nn.Linear(width, width, **f)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.num_heads
        q, k, v = lin(_ada_ln(x, t, self.ada1, self.ln_eps), self.qkv).chunk(3, dim=-1)
        o = attention(_split_heads(q, h), _split_heads(k, h), _split_heads(v, h),
                      dual_sqrt_scale=True)
        x = x + lin(_merge_heads(o), self.attn_out)
        if context is not None:
            q = lin(_ada_ln(x, t, self.ada2, self.ln_eps), self.cross_q)
            k, v = lin(context, self.cross_kv).chunk(2, dim=-1)
            o = attention(_split_heads(q, h), _split_heads(k, h), _split_heads(v, h),
                          dual_sqrt_scale=True)
            x = x + lin(_merge_heads(o), self.cross_out)
        y = _ada_ln(x, t, self.ada3, self.ln_eps)
        return x + lin(gelu(lin(y, self.fc)), self.fc_out)


# ---------------------------------------------------------------------------
# training objective (ASLDiffuser.forward + compute_loss)


def diffusion_loss_with(model: UDTDenoiser, latents: torch.Tensor, context: torch.Tensor,
                        noise: torch.Tensor, timesteps: torch.Tensor,
                        keep: torch.Tensor) -> torch.Tensor:
    """The eps-MSE given its draws: ``noise`` like ``latents``,
    ``timesteps`` (B,) int, ``keep`` (B, 1, 1) bool (the condition kept)."""
    context = context * keep.to(context.dtype)
    noisy = add_noise(model.cfg, latents, noise, timesteps)
    return torch.mean((model(noisy, timesteps, context) - noise) ** 2)


def diffusion_loss(model: UDTDenoiser, latents: torch.Tensor, context: torch.Tensor, *,
                   generator: torch.Generator, cond_drop_prob: float = 0.1) -> torch.Tensor:
    """eps-prediction MSE with condition dropout
    (asl_diffuser_pl_module.py:322-348, compute_loss "noise" branch), the
    draws taken from ``generator``."""
    b, dev = latents.shape[0], latents.device
    keep = torch.rand((b, 1, 1), generator=generator, device=dev) >= cond_drop_prob
    noise = torch.randn(latents.shape, generator=generator, device=dev, dtype=latents.dtype)
    t = torch.randint(0, model.cfg.num_train_timesteps, (b,), generator=generator, device=dev)
    return diffusion_loss_with(model, latents, context, noise, t, keep)


# ---------------------------------------------------------------------------
# samplers


def _cfg_eps(model, x, t, cond, uncond, guidance_scale):
    """Classifier-free guidance: one batched forward over [uncond ‖ cond]
    (inference_utils.py:52-70)."""
    if guidance_scale <= 0:
        return model(x, t, cond)
    eps_u, eps_c = model(torch.cat([x, x]), torch.cat([t, t]),
                         torch.cat([uncond, cond])).chunk(2)
    return eps_u + guidance_scale * (eps_c - eps_u)


def _initial(x_T, context, shape, generator) -> torch.Tensor:
    """``x_T``, else a unit normal draw of (B, *shape) from ``generator``."""
    if x_T is not None:
        return x_T.to(device=context.device, dtype=context.dtype)
    return torch.randn((context.shape[0], *shape), generator=generator,
                       device=context.device, dtype=context.dtype)


@torch.no_grad()
def ddim_sample(model: UDTDenoiser, context: torch.Tensor, *, shape, steps: int = 50,
                guidance_scale: float = 3.0, eta: float = 0.0,
                uncond: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DDIM reverse process with "leading" timestep spacing
    (inference_utils.py:12-76 semantics). ``shape``: a sample's latent
    shape, e.g. (n_ctx, embed_dim). ``x_T`` (B, *shape) is the initial
    latent, else drawn from ``generator``; the noise of ``eta`` > 0 is
    drawn from ``generator`` too. At eta = 0 no noise is drawn, and the
    trajectory is a function of ``x_T`` alone."""
    cfg = model.cfg
    b, dev = context.shape[0], context.device
    if uncond is None:
        uncond = torch.zeros_like(context)
    if not 0 < steps <= cfg.num_train_timesteps:
        raise ValueError(
            f"steps={steps} must be in [1, num_train_timesteps="
            f"{cfg.num_train_timesteps}] (a larger value would collapse "
            "the schedule to t=0)")
    a_bar = alphas_cumprod(cfg)
    stride = cfg.num_train_timesteps // steps
    ts = torch.arange(steps - 1, -1, -1) * stride
    # the whole schedule on the host, as f32 tensors moved once to the device
    at = a_bar[ts]
    at_prev = torch.where(ts - stride >= 0, a_bar[(ts - stride).clamp(min=0)],
                          torch.ones(()))
    sigma = eta * torch.sqrt((1 - at_prev) / (1 - at)) * torch.sqrt(1 - at / at_prev)
    coef = {k: v.to(dev) for k, v in {
        "sqrt_1m_at": torch.sqrt(1 - at), "sqrt_at": torch.sqrt(at),
        "sqrt_at_prev": torch.sqrt(at_prev), "sigma": sigma,
        "dir": torch.sqrt(torch.clamp(1 - at_prev - sigma ** 2, min=0.0))}.items()}
    t_dev = ts.to(dev)

    x = _initial(x_T, context, shape, generator)
    for i in range(steps):
        eps = _cfg_eps(model, x, t_dev[i].expand(b), context, uncond, guidance_scale)
        x0 = (x - coef["sqrt_1m_at"][i] * eps) / coef["sqrt_at"][i]
        x = coef["sqrt_at_prev"][i] * x0 + coef["dir"][i] * eps
        if eta > 0:
            x = x + coef["sigma"][i] * torch.randn(x.shape, generator=generator,
                                                   device=dev, dtype=x.dtype)
    return x


@torch.no_grad()
def karras_sample(model: UDTDenoiser, context: torch.Tensor, *, shape, steps: int = 32,
                  guidance_scale: float = 3.0, sigma_min: float = 0.002,
                  sigma_max: float = 80.0, rho: float = 7.0,
                  uncond: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Karras/EDM sigma schedule with Heun's 2nd-order corrector and Euler
    at the last (sigma -> 0) step. The eps-model is an EDM denoiser by the
    VP <-> sigma change of variables (sigma_t = sqrt((1-a)/a),
    x_vp = x_edm / sqrt(1 + sigma^2)); each sigma takes the nearest
    trained timestep. ``x_T`` is the unit-variance draw that is scaled by
    sigma_max (JAX's ``normal(k0)``), else drawn from ``generator``."""
    cfg = model.cfg
    b, dev = context.shape[0], context.device
    if uncond is None:
        uncond = torch.zeros_like(context)
    a_bar = alphas_cumprod(cfg)
    vp_sigmas = torch.sqrt((1 - a_bar) / a_bar)
    i = torch.arange(steps, dtype=torch.float32)
    sig = (sigma_max ** (1 / rho)
           + i / (steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    sig = torch.cat([sig, torch.zeros(1)])
    # the nearest trained timestep of every sigma, on the host before the loop
    t_of = torch.argmin(torch.abs(vp_sigmas[None] - sig[:, None]), dim=1).to(dev)
    sig_dev = sig.to(dev)

    def eps_at(x, k):
        x_vp = x / torch.sqrt(1 + sig_dev[k] ** 2)
        return _cfg_eps(model, x_vp, t_of[k].expand(b), context, uncond, guidance_scale)

    x = _initial(x_T, context, shape, generator) * sigma_max
    for k in range(steps):
        ds = sig_dev[k + 1] - sig_dev[k]
        d = eps_at(x, k)
        x_euler = x + ds * d
        if k + 1 < steps:                 # sig[steps] = 0: Euler at the last step
            x = x + ds * 0.5 * (d + eps_at(x_euler, k + 1))
        else:
            x = x_euler
    return x / math.sqrt(1 + sigma_min ** 2)
