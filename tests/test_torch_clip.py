"""The port's CLIP towers and wrappers (``models/clip_cond.py``) and the
CLIP-conditioned diffuser (``models/clip_diffuser.py``) held to the JAX
package, in f32, on one seeded numpy state dict in the HF CLIPModel layout
(built here from the key names and shapes, so ``transformers`` is not
needed), fed to both packages' converters.

Widths are the JAX tests' (tests/test_clip_cond.py, test_clip_diffuser.py);
the text config's eos id (60) is not the largest id, so pooling at the
first eos differs from pooling at the largest id.

Tolerances (absolute and relative): 2e-5 for the towers, the wrappers
and ``preprocess_image`` (f32; the resize is two products with JAX's
weights: 1.4e-6 to 3.2e-6 from JAX's normalized pixels measured); the
end-to-end meshes with equal faces and vertices at 1e-4 (the sampled
latents through the VAE decoder and marching, where a vertex
interpolates between two logits; 1.9e-6 measured)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.config import PerceiverConfig as JPerceiverConfig
from meshanything_tpu.models import clip_cond as jcc
from meshanything_tpu.models import clip_diffuser as jcd
from meshanything_tpu.models import diffusion as jdm
from meshanything_tpu.models import perceiver as jper
from meshanything_tpu_torch.config import PerceiverConfig
from meshanything_tpu_torch.models import clip_cond as cc
from meshanything_tpu_torch.models import clip_diffuser as cd
from meshanything_tpu_torch.models import diffusion as dm
from meshanything_tpu_torch.runtime.checkpoint import perceiver_from_jax_numpy, udt_from_jax_numpy

ATOL = 2e-5
MESH_ATOL = 1e-4

TEXT = dict(vocab_size=99, width=32, layers=2, heads=4, max_positions=12, projection_dim=24,
            eos_token_id=60)
VISION = dict(image_size=16, patch_size=4, width=32, layers=2, heads=4, projection_dim=24)
TCFG, JTCFG = cc.CLIPTextConfig(**TEXT), jcc.CLIPTextConfig(**TEXT)
VCFG, JVCFG = cc.CLIPVisionConfig(**VISION), jcc.CLIPVisionConfig(**VISION)


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def hf_clip_state_dict(tcfg, vcfg, seed: int = 0) -> dict:
    """Seeded f32 values under HF CLIPModel's key names: N(0, 0.02) weights
    and biases, layer-norm scales near 1."""
    rng = np.random.default_rng(seed)
    sd = {}

    def w(name, *shape, scale=0.02):
        sd[name] = (rng.normal(size=shape) * scale).astype(np.float32)

    def norm(name, d):
        w(name + ".weight", d, scale=0.1)
        sd[name + ".weight"] += 1.0
        w(name + ".bias", d)

    def layers(prefix, d, n):
        for i in range(n):
            lp = f"{prefix}.encoder.layers.{i}."
            for proj in ("q", "k", "v", "out"):
                w(f"{lp}self_attn.{proj}_proj.weight", d, d)
                w(f"{lp}self_attn.{proj}_proj.bias", d)
            norm(lp + "layer_norm1", d)
            norm(lp + "layer_norm2", d)
            w(lp + "mlp.fc1.weight", 4 * d, d)
            w(lp + "mlp.fc1.bias", 4 * d)
            w(lp + "mlp.fc2.weight", d, 4 * d)
            w(lp + "mlp.fc2.bias", d)

    d = tcfg.width
    w("text_model.embeddings.token_embedding.weight", tcfg.vocab_size, d)
    w("text_model.embeddings.position_embedding.weight", tcfg.max_positions, d)
    layers("text_model", d, tcfg.layers)
    norm("text_model.final_layer_norm", d)
    w("text_projection.weight", tcfg.projection_dim, d)
    d, p = vcfg.width, vcfg.patch_size
    w("vision_model.embeddings.class_embedding", d)
    w("vision_model.embeddings.patch_embedding.weight", d, 3, p, p)
    w("vision_model.embeddings.position_embedding.weight", 1 + vcfg.num_patches, d)
    norm("vision_model.pre_layrnorm", d)
    layers("vision_model", d, vcfg.layers)
    norm("vision_model.post_layernorm", d)
    w("visual_projection.weight", vcfg.projection_dim, d)
    return sd


@pytest.fixture(scope="module")
def clip():
    sd = hf_clip_state_dict(TCFG, VCFG)
    return (sd, jcc.convert_clip_text(sd, JTCFG), jcc.convert_clip_vision(sd, JVCFG),
            cc.convert_clip_text(sd, TCFG), cc.convert_clip_vision(sd, VCFG))


# JAX's towers jitted: one compile instead of one per eager op
j_text = jax.jit(jcc.clip_text_forward, static_argnums=1)
j_text_features = jax.jit(jcc.clip_text_features, static_argnums=1)
j_vision = jax.jit(jcc.clip_vision_forward, static_argnums=1)
j_image_features = jax.jit(jcc.clip_image_features, static_argnums=1)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=atol)


def _ids(rng):
    ids = rng.integers(1, TCFG.vocab_size - 1, size=(3, TCFG.max_positions))
    ids[ids == TCFG.eos_token_id] = 1
    ids[:, 0] = TCFG.eos_token_id - 1
    ids[0, 5] = TCFG.eos_token_id
    ids[1, -1] = TCFG.eos_token_id
    ids[2, 3] = ids[2, 8] = TCFG.eos_token_id        # the first of two eos pools
    ids[:, 1] = TCFG.vocab_size - 1                   # the largest id is not eos
    return ids


def test_text_tower_matches_jax(clip):
    _, jt, _, text, _ = clip
    ids = _ids(np.random.default_rng(0))
    with torch.no_grad():
        h, pooled = text(torch.from_numpy(ids))
        feats = text.features(torch.from_numpy(ids))
    jh, jpool = j_text(jt, JTCFG, jnp.asarray(ids, jnp.int32))
    _close(h, jh)
    _close(pooled, jpool)
    _close(pooled, h[torch.arange(3), torch.tensor([5, 11, 3])])
    _close(feats, j_text_features(jt, JTCFG, jnp.asarray(ids, jnp.int32)))
    _close(cc.text_embedding(text, torch.from_numpy(ids)), jh)


def test_vision_tower_matches_jax(clip):
    _, _, jv, _, vision = clip
    px = np.random.default_rng(1).normal(size=(2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        h, pooled = vision(torch.from_numpy(px))
        feats = vision.features(torch.from_numpy(px))
    jh, jpool = j_vision(jv, JVCFG, jnp.asarray(px))
    assert h.shape == (2, 1 + VCFG.num_patches, VCFG.width)
    _close(h, jh)
    _close(pooled, jpool)
    _close(feats, j_image_features(jv, JVCFG, jnp.asarray(px)))


def test_patch_embedding_is_the_hf_conv(clip):
    """The linear over (row, col, channel)-unfolded patches equals the HF
    stride-p convolution it was converted from."""
    sd, _, _, _, vision = clip
    px = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 3, 16, 16)).astype(np.float32))
    conv = torch.nn.functional.conv2d(
        px, torch.from_numpy(sd["vision_model.embeddings.patch_embedding.weight"]), stride=4)
    p = VCFG.patch_size
    patches = px.permute(0, 2, 3, 1).reshape(1, 4, p, 4, p, 3).permute(0, 1, 3, 2, 4, 5)
    ours = patches.reshape(1, 16, p * p * 3) @ vision.patch_embedding.weight.T
    _close(ours, conv.flatten(2).transpose(1, 2), 1e-6)


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("shape", [(20, 27), (11, 13), (16, 16), (40, 23)],
                         ids=["down", "up", "same", "down_tall"])
def test_preprocess_image_matches_jax(method, shape):
    img = np.random.default_rng(3).uniform(-1, 1, size=(2, 3, *shape)).astype(np.float32)
    ours = cc.preprocess_image(torch.from_numpy(img), 16, method=method)
    assert ours.shape == (2, 3, 16, 16)
    _close(ours, jcc.preprocess_image(jnp.asarray(img), 16, method=method))


def test_resize_is_not_interpolate():
    """JAX's antialiased Keys cubic (a = -0.5) is not F.interpolate's
    bicubic (a = -0.75): the port carries its own weights."""
    img = torch.from_numpy(np.random.default_rng(4).uniform(size=(1, 3, 20, 27)).astype(np.float32))
    ours = cc.resize_image(img, 16, 22, "cubic")
    theirs = torch.nn.functional.interpolate(img, (16, 22), mode="bicubic", align_corners=False)
    assert (ours - theirs).abs().max() > 1e-3
    w = cc.resize_weights(27, 22, "cubic")
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-6)


def test_image_wrappers_match_jax(clip):
    _, _, jv, _, vision = clip
    img = np.random.default_rng(5).uniform(-1, 1, size=(2, 3, 20, 24)).astype(np.float32)
    with torch.no_grad():
        z = cc.image_embedding(vision, torch.from_numpy(img))
        grid = cc.image_grid_embedding(vision, torch.from_numpy(img))
        z_drop = cc.image_embedding(vision, torch.from_numpy(img), zero_embedding_radio=1.0,
                                    generator=torch.Generator().manual_seed(0))
        z_keep = cc.image_embedding(vision, torch.from_numpy(img), zero_embedding_radio=1e-9,
                                    generator=torch.Generator().manual_seed(0))
    assert z.shape == (2, 1, VCFG.projection_dim)
    _close(z, jax.jit(jcc.image_embedding, static_argnums=1)(jv, JVCFG, jnp.asarray(img)))
    np.testing.assert_allclose(torch.linalg.norm(z, dim=-1).numpy(), 1.0, rtol=1e-5)
    _close(grid, jax.jit(jcc.image_grid_embedding, static_argnums=1)(jv, JVCFG, jnp.asarray(img)))
    assert torch.count_nonzero(z_drop) == 0
    assert torch.equal(z_keep, z)


def test_unconditional_ids_templates_and_class_embedder():
    ids = cc.unconditional_text_ids(TCFG, 3, bos=TCFG.eos_token_id - 1)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jcc.unconditional_text_ids(JTCFG, 3, bos=TCFG.eos_token_id - 1)))
    assert cc.load_text_templates("shape") == jcc.load_text_templates("shape")
    assert len(cc.load_text_templates()) == 64
    assert cc.expand_text_templates("chair") == jcc.expand_text_templates("chair")
    p = jcc.init_class_embedder(jax.random.PRNGKey(0), embed_dim=16, n_classes=10)
    emb = cc.ClassEmbedder(16, 10, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        emb.embedding.weight.copy_(torch.from_numpy(np.asarray(p["embedding"])))
        z = emb(torch.tensor([3, 7]))
    assert z.shape == (2, 1, 16)
    _close(z, jcc.class_embedding(p, jnp.asarray([3, 7])), 0)


# ---------------------------------------------------------------------------
# clip_diffuser end to end (widths of tests/test_clip_diffuser.py)

PER = dict(num_latents=8, embed_dim=8, width=48, heads=4, num_encoder_layers=1,
           num_decoder_layers=1, num_points=32)
DIFF = dict(input_channels=8, output_channels=8, n_ctx=8, width=48, layers=1, heads=4,
            context_dim=24, num_train_timesteps=50)


@pytest.fixture(scope="module")
def diffuser(clip):
    jpcfg, pcfg = JPerceiverConfig(**PER), PerceiverConfig(**PER)
    jdcfg, dcfg = jdm.DiffusionConfig(**DIFF), dm.DiffusionConfig(**DIFF)
    jp = jax.jit(jper.init_perceiver_params, static_argnums=1)(jax.random.PRNGKey(0), jpcfg)
    jd = jax.jit(jdm.init_udt_params, static_argnums=1)(jax.random.PRNGKey(1), jdcfg)
    p = perceiver_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp), pcfg)
    d = udt_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jd), dcfg)
    return jpcfg, pcfg, jdcfg, jp, jd, p, d


def test_encode_first_stage_matches_jax(diffuser):
    jpcfg, pcfg, _, jp, _, p, _ = diffuser
    surf = (np.random.default_rng(6).normal(size=(2, 32, 6)) * 0.4).astype(np.float32)
    with torch.no_grad():
        mode = cd.encode_first_stage(p, pcfg, torch.from_numpy(surf))
        draws = [cd.encode_first_stage(p, pcfg, torch.from_numpy(surf),
                                       torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    _close(mode, jax.jit(jcd.encode_first_stage, static_argnums=1)(jp, jpcfg, jnp.asarray(surf)))
    assert torch.equal(draws[0], draws[1]) and not torch.allclose(draws[0], draws[2])
    assert not torch.allclose(draws[0], mode)


def test_clip_diffuser_loss_grads_reach_the_denoiser_only(clip, diffuser):
    _, pcfg, _, _, _, p, d = diffuser
    vision = clip[4]
    rng = np.random.default_rng(7)
    surf = torch.from_numpy((rng.normal(size=(2, 32, 6)) * 0.4).astype(np.float32))
    img = torch.from_numpy(rng.uniform(-1, 1, size=(2, 3, 16, 16)).astype(np.float32))
    loss = cd.clip_diffuser_loss(d, p, pcfg, vision, surf, img,
                                 generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss)
    assert all(q.grad is not None and torch.isfinite(q.grad).all() for q in d.parameters())
    assert all(q.grad is None and not q.requires_grad
               for q in (*p.parameters(), *vision.parameters()))
    d.zero_grad(set_to_none=True)
    # the same draws in order: the posterior sample, then the loss's
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        latents = cd.encode_first_stage(p, pcfg, surf, gen)
        again = dm.diffusion_loss(d, latents, cc.image_embedding(vision, img), generator=gen)
    assert torch.equal(loss.detach(), again)


def _compare_meshes(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.faces, b.faces)
            np.testing.assert_allclose(a.vertices, b.vertices, atol=MESH_ATOL)


@pytest.mark.parametrize("cond", ["image", "text"])
def test_sample_shapes_match_jax(clip, diffuser, cond):
    _, jt, jv, text, vision = clip
    jpcfg, pcfg, jdcfg, jp, jd, p, d = diffuser
    key = jax.random.PRNGKey(0)
    x_T = jax.random.normal(jax.random.split(key)[1], (1, pcfg.num_latents, pcfg.embed_dim))
    kw = dict(steps=4, guidance_scale=2.0, octree_depth=4)
    if cond == "image":
        img = np.random.default_rng(8).uniform(-1, 1, size=(1, 3, 16, 16)).astype(np.float32)
        ref = jcd.sample_shapes_from_image(jd, jdcfg, jp, jpcfg, jv, JVCFG, jnp.asarray(img),
                                           key, **kw)
        ours = cd.sample_shapes_from_image(d, p, pcfg, vision, torch.from_numpy(img),
                                           x_T=torch.from_numpy(np.asarray(x_T)), **kw)
    else:
        ids = _ids(np.random.default_rng(9))[:1]
        ref = jcd.sample_shapes_from_text(jd, jdcfg, jp, jpcfg, jt, JTCFG,
                                          jnp.asarray(ids, jnp.int32), key, **kw)
        ours = cd.sample_shapes_from_text(d, p, pcfg, text, torch.from_numpy(ids),
                                          x_T=torch.from_numpy(np.asarray(x_T)), **kw)
    _compare_meshes(ours, ref)


def test_sample_latents_draw_from_the_generator(diffuser):
    _, pcfg, _, _, _, _, d = diffuser
    cond = torch.zeros(1, 1, 24)
    runs = [cd.sample_latents_from_cond(d, cond, num_latents=8, embed_dim=8, steps=3,
                                        generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert runs[0].shape == (1, 8, 8)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
