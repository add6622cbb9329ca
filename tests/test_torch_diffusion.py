"""The port's ASL diffusion tier and embedders (``models/diffusion.py``,
``models/embedders.py``) held to the JAX package on the same weights (the
bridges of ``runtime/checkpoint.py``) and the same seeded inputs, in f32,
on ``small_diffusion_config()``.

JAX draws with threefry keys and the port with a ``torch.Generator``, so
where JAX draws, the test splits the key as JAX does and hands the port
the same numbers: the loss's noise, timesteps and condition mask, and
the samplers' initial latent.

Tolerances (absolute and relative): 1e-5 for the embedders and the
timestep embedding; 2e-5 for ``denoise``, ``dit_block`` and the loss
(f32 through 5 blocks); the schedule at 1e-6 (XLA fuses and orders the
f32 linspace and cumprod its own way: a few ulps); 1e-5 for the DDIM
(eta = 0) and Karras trajectories (those ulps of the schedule through 10
and 8 steps: 1.2e-6 of |x| ~3.4 and 3e-5 of |x| ~210 measured)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.models import diffusion as jdm
from meshanything_tpu.models import embedders as jem
from meshanything_tpu_torch.models import diffusion as dm
from meshanything_tpu_torch.models import embedders as em
from meshanything_tpu_torch.runtime.checkpoint import dit_from_jax_numpy, udt_from_jax_numpy

ATOL = 1e-5
MODEL_ATOL = 2e-5
SCHEDULE_ATOL = 1e-6
SAMPLER_ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    jcfg = jdm.small_diffusion_config()
    params = jax.jit(jdm.init_udt_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    cfg = dm.small_diffusion_config()
    model = udt_from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jcfg, cfg, params, model


# JAX's references jitted: one compile instead of one per eager op
j_denoise = jax.jit(jdm.denoise, static_argnums=1)
j_loss = jax.jit(jdm.diffusion_loss, static_argnums=(1, 5))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(a, b, atol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=atol)


def test_config_fields_match_jax():
    import dataclasses

    for j, p in ((jdm.DiffusionConfig(), dm.DiffusionConfig()),
                 (jdm.small_diffusion_config(), dm.small_diffusion_config())):
        assert dataclasses.asdict(j) == dataclasses.asdict(p)


@pytest.mark.parametrize("which", ["full", "small"])
def test_alphas_cumprod_matches_jax(which):
    jcfg = jdm.DiffusionConfig() if which == "full" else jdm.small_diffusion_config()
    cfg = dm.DiffusionConfig() if which == "full" else dm.small_diffusion_config()
    ours = dm.alphas_cumprod(cfg)
    assert ours.dtype == torch.float32 and ours.shape == (cfg.num_train_timesteps,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jdm.alphas_cumprod(jcfg)),
                               atol=SCHEDULE_ATOL, rtol=0)


@pytest.mark.parametrize("dim,flip", [(8, False), (8, True), (9, False), (48, True)])
def test_timestep_embedding_matches_jax(dim, flip):
    t = np.array([0, 1, 50, 99, 999])
    _close(dm.timestep_embedding(_t(t), dim, flip_sin_to_cos=flip),
           jdm.timestep_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip), ATOL)


def test_add_noise_matches_jax(setup):
    jcfg, cfg, _, _ = setup
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, cfg.n_ctx, cfg.input_channels)).astype(np.float32)
    n = rng.normal(size=x.shape).astype(np.float32)
    t = np.array([0, 40, 99])
    _close(dm.add_noise(cfg, _t(x), _t(n), _t(t)),
           jdm.add_noise(jcfg, jnp.asarray(x), jnp.asarray(n), jnp.asarray(t)), ATOL)


@pytest.mark.parametrize("n_cond", [1, 3])
def test_denoise_matches_jax(setup, n_cond):
    jcfg, cfg, params, model = setup
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, cfg.n_ctx, cfg.input_channels)).astype(np.float32)
    ctx = rng.normal(size=(2, n_cond, cfg.context_dim)).astype(np.float32)
    t = np.array([3, 77])
    with torch.no_grad():
        ours = model(_t(x), _t(t), _t(ctx))
    assert ours.shape == (2, cfg.n_ctx, cfg.output_channels)
    _close(ours, j_denoise(params, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)),
           MODEL_ATOL)


@pytest.mark.parametrize("cross", [False, True])
def test_dit_block_matches_jax(cross):
    w, heads = 48, 4
    p = jdm.init_dit_block(jax.random.PRNGKey(0), w, context_dim=32 if cross else None)
    block = dit_from_jax_numpy(jax.tree_util.tree_map(np.asarray, p), w, heads)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, w)).astype(np.float32)
    t = rng.normal(size=(2, 1, w)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, 32)).astype(np.float32) if cross else None
    with torch.no_grad():
        ours = block(_t(x), _t(t), None if ctx is None else _t(ctx))
    ref = jax.jit(lambda *a: jdm.dit_block(*a[:3], num_heads=heads, context=a[3]))(
        jnp.asarray(x), jnp.asarray(t), p, None if ctx is None else jnp.asarray(ctx))
    _close(ours, ref, MODEL_ATOL)


def _jax_loss_draws(key, latents, cfg, cond_drop_prob):
    """diffusion_loss's draws, split as JAX splits them."""
    k_mask, k_noise, k_t = jax.random.split(key, 3)
    keep = jax.random.uniform(k_mask, (latents.shape[0], 1, 1)) >= cond_drop_prob
    noise = jax.random.normal(k_noise, latents.shape, latents.dtype)
    t = jax.random.randint(k_t, (latents.shape[0],), 0, cfg.num_train_timesteps)
    return keep, noise, t


@pytest.mark.parametrize("seed", [0, 7])
def test_diffusion_loss_with_jax_draws(setup, seed):
    jcfg, cfg, params, model = setup
    rng = np.random.default_rng(4)
    latents = rng.normal(size=(4, cfg.n_ctx, cfg.input_channels)).astype(np.float32)
    ctx = rng.normal(size=(4, 1, cfg.context_dim)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    keep, noise, t = jax.jit(_jax_loss_draws, static_argnums=(2, 3))(
        key, jnp.asarray(latents), jcfg, 0.5)
    ref = j_loss(params, jcfg, key, jnp.asarray(latents), jnp.asarray(ctx), 0.5)
    ours = dm.diffusion_loss_with(model, _t(latents), _t(ctx), _t(noise), _t(t), _t(keep))
    _close(ours, ref, MODEL_ATOL)
    # the grads reach every parameter of the denoiser
    ours.backward()
    assert all(p.grad is not None for p in model.parameters())
    model.zero_grad(set_to_none=True)


def test_diffusion_loss_draws_from_the_generator(setup):
    _, cfg, _, model = setup
    latents = torch.randn(2, cfg.n_ctx, cfg.input_channels, generator=torch.Generator().manual_seed(0))
    ctx = torch.randn(2, 1, cfg.context_dim, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b, c = (dm.diffusion_loss(model, latents, ctx, generator=torch.Generator().manual_seed(s))
                   for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a)


@pytest.mark.parametrize("guidance", [0.0, 3.0])
def test_ddim_eta0_trajectory_matches_jax(setup, guidance):
    jcfg, cfg, params, model = setup
    rng = np.random.default_rng(5)
    ctx = rng.normal(size=(2, 1, cfg.context_dim)).astype(np.float32)
    shape = (cfg.n_ctx, cfg.output_channels)
    key = jax.random.PRNGKey(1)
    ref = jax.jit(lambda p, k, c: jdm.ddim_sample(p, jcfg, k, c, shape=shape, steps=10,
                                                  guidance_scale=guidance, eta=0.0))(
        params, key, jnp.asarray(ctx))
    x_T = jax.random.normal(jax.random.split(key)[1], (2, *shape), jnp.float32)
    ours = dm.ddim_sample(model, _t(ctx), shape=shape, steps=10, guidance_scale=guidance,
                          eta=0.0, x_T=_t(x_T))
    _close(ours, ref, SAMPLER_ATOL)


def test_ddim_checks_steps_and_draws_with_eta(setup):
    _, cfg, _, model = setup
    ctx = torch.zeros(1, 1, cfg.context_dim)
    shape = (cfg.n_ctx, cfg.output_channels)
    with pytest.raises(ValueError, match="steps"):
        dm.ddim_sample(model, ctx, shape=shape, steps=cfg.num_train_timesteps + 1)
    with pytest.raises(ValueError, match="steps"):
        dm.ddim_sample(model, ctx, shape=shape, steps=0)
    runs = [dm.ddim_sample(model, ctx, shape=shape, steps=4, eta=1.0,
                           generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_karras_trajectory_matches_jax(setup):
    jcfg, cfg, params, model = setup
    rng = np.random.default_rng(6)
    ctx = rng.normal(size=(1, 1, cfg.context_dim)).astype(np.float32)
    shape = (cfg.n_ctx, cfg.output_channels)
    key = jax.random.PRNGKey(2)
    ref = jax.jit(lambda p, k, c: jdm.karras_sample(p, jcfg, k, c, shape=shape, steps=8,
                                                    guidance_scale=1.5))(
        params, key, jnp.asarray(ctx))
    x_T = jax.random.normal(jax.random.split(key)[1], (1, *shape), jnp.float32)
    ours = dm.karras_sample(model, _t(ctx), shape=shape, steps=8, guidance_scale=1.5,
                            x_T=_t(x_T))
    _close(ours, ref, SAMPLER_ATOL)


def test_learned_and_triplane_fourier_match_jax():
    rng = np.random.default_rng(7)
    p = jem.init_learned_fourier(jax.random.PRNGKey(0), 3, 24)
    x = rng.normal(size=(2, 5, 3)).astype(np.float32)
    _close(em.learned_fourier(_t(p["weights"]), _t(x)), jem.learned_fourier(p, jnp.asarray(x)),
           ATOL)
    assert em.learned_fourier_out_dim(3, 24) == jem.learned_fourier_out_dim(3, 24)
    tp = jem.init_triplane_fourier(jax.random.PRNGKey(1), 3, 24)
    tri = em.TriplaneFourier(3, 24)
    with torch.no_grad():
        for plane in ("yz", "xz", "xy"):
            getattr(tri, plane).weights.copy_(_t(tp[plane]["weights"]))
        _close(tri(_t(x)), jem.triplane_fourier(tp, jnp.asarray(x)), ATOL)
    with pytest.raises(ValueError, match="even"):
        em.LearnedFourier(3, 25)


def test_sequential_pos_embed_matches_jax():
    _close(em.sequential_pos_embed(6, 8), jem.sequential_pos_embed(6, 8), ATOL)
    with pytest.raises(ValueError, match="even"):
        em.sequential_pos_embed(4, 7)


def test_get_embedder_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 3)).astype(np.float32)
    for kind, freqs in (("identity", -1), ("fourier", -1), ("fourier", 8)):
        fn, d = em.get_embedder(kind, num_freqs=freqs, input_dim=3, include_pi=False)
        jfn, jd = jem.get_embedder(kind, num_freqs=freqs, input_dim=3, include_pi=False)
        assert d == jd
        _close(fn(_t(x)), jfn(jnp.asarray(x)), ATOL)
    module, d = em.get_embedder("learned_fourier", input_dim=3, learned_dim=24,
                                generator=torch.Generator().manual_seed(0))
    assert d == jem.get_embedder("learned_fourier", input_dim=3, learned_dim=24)[1]
    assert module(_t(x)).shape == (2, d)
    with pytest.raises(ValueError, match="hashgrid"):
        em.get_embedder("hashgrid")
