"""The trainer of the PyTorch port on the small config in f32, held to the
JAX package on weights made by ``init_meshanything_params`` and bridged
with ``params_from_jax_numpy``: the teacher-forcing forward, every
parameter's grad, the optimizer recipe step for step, the losses, the VAE
path through ``query_geometry``, checkpoints and resume, ``main``'s flags,
and the host data pipeline (bit-equal for the same rng)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.models import perceiver as jper
from meshanything_tpu.models.layers import linear as jlinear
from meshanything_tpu.training import data as jdata
from meshanything_tpu.training import losses as jlosses
from meshanything_tpu.training import optim as joptim
from meshanything_tpu.training import train as jtrain
from meshanything_tpu.training import transforms as jtransforms
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.geometry.obj_io import Mesh
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import perceiver as per
from meshanything_tpu_torch.models.layers import lin
from meshanything_tpu_torch.runtime.checkpoint import init_random_params, params_from_jax_numpy
from meshanything_tpu_torch.training import data as tdata
from meshanything_tpu_torch.training import losses
from meshanything_tpu_torch.training import train as ttrain
from meshanything_tpu_torch.training import transforms as ttransforms
from meshanything_tpu_torch.training.optim import make_optimizer

N_MAX = 4
SEQ = 21        # the JAX test's length: 17 + 21 = 38 positions, not a multiple of 8


_init = jax.jit(jma.init_meshanything_params, static_argnums=1)   # a third of the eager time


def _tree(cfg, seed=0):
    return jax.tree_util.tree_map(np.array, _init(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops: with the test runner's workers
    sharing the cores, torch's thread pool per worker turns them into a
    spin-wait contest (a 10 s test took 600 s). One thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bridged():
    """(JAX cfg, JAX params, port cfg, port model, one make_batch batch)."""
    jcfg = jax_small_config(n_max_triangles=N_MAX)
    tree = _tree(jcfg)
    cfg = small_test_config(n_max_triangles=N_MAX)
    batch = jtrain.make_batch(jcfg, np.random.default_rng(0), batch=2, seq=SEQ)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg, params_from_jax_numpy(tree, cfg), batch


@pytest.fixture(scope="module")
def jax_grad_fn(bridged):
    """jax.value_and_grad of JAX's loss_fn (remat on) on the bridged
    config, compiled once for the grads test and both optimizer cases."""
    jcfg = bridged[0]
    return jax.jit(jax.value_and_grad(functools.partial(jtrain.loss_fn, cfg=jcfg), has_aux=True))


def _named(model):
    return dict(model.named_parameters())


# ---------------------------------------------------------------------------
# forward and grads


@pytest.mark.parametrize("remat,block_q", [(False, 0), (True, 8)])
def test_forward_logits_matches_jax(bridged, remat, block_q):
    """The teacher-forcing logits of both packages on the same weights and
    inputs, at atol 1e-5: dense attention, and remat with block_q=8 (JAX
    pads 38 positions to 40 there, the port runs SDPA unpadded)."""
    jcfg, jparams, cfg, model, (pc, ids, _) = bridged
    want = np.asarray(jma.forward_logits(jparams, jcfg, jnp.asarray(pc), jnp.asarray(ids),
                                         remat=remat, block_q=block_q))
    with torch.no_grad():
        got = ma.forward_logits(model, cfg, torch.from_numpy(pc), torch.from_numpy(ids).long(),
                                remat=remat, block_q=block_q)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 17 + SEQ, 67)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_forward_promotes_to_f32_weights_like_jax(bridged):
    """At a bf16 config with f32 master weights the perceiver runs in bf16
    and the decoder in f32 in both packages (JAX's concatenate promotes
    the bf16 condition to the f32 token embedding): held at 2e-2, the
    bf16 perceiver's rounding, where a bf16 decoder would be ~10x off."""
    jcfg, jparams, cfg, model, (pc, ids, _) = bridged
    jcfg16, cfg16 = (dataclasses.replace(c, dtype="bfloat16") for c in (jcfg, cfg))
    want = np.asarray(jma.forward_logits(jparams, jcfg16, jnp.asarray(pc), jnp.asarray(ids)))
    with torch.no_grad():
        got = ma.forward_logits(model, cfg16, torch.from_numpy(pc), torch.from_numpy(ids).long())
        _, cond = ma.encode(model, cfg16, torch.from_numpy(pc))
    assert cond.dtype == torch.bfloat16 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


def test_grads_match_jax(bridged, jax_grad_fn):
    """Loss and every parameter's grad against jax.value_and_grad of JAX's
    loss_fn (remat on), JAX's grad tree bridged through
    params_from_jax_numpy and compared by name (rtol 1e-4, atol 1e-6); the
    NRD, which the pass does not reach, has zero grads in JAX and none in
    the port."""
    jcfg, jparams, cfg, model, (pc, ids, labels) = bridged
    (jloss, _), jgrads = jax_grad_fn(jparams, pc_normal=jnp.asarray(pc), token_ids=jnp.asarray(ids),
                                 labels=jnp.asarray(labels))
    want = _named(params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, jgrads), cfg))
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():     # another test file's entry point may have turned it off
        loss, _ = ttrain.loss_fn(model, cfg, torch.from_numpy(pc), torch.from_numpy(ids).long(),
                                 torch.from_numpy(labels).long())
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, p in _named(model).items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name].detach().numpy(), rtol=GRAD_RTOL,
                                   atol=1e-6, err_msg=name)
    assert all(p.grad is None for p in model.nrd.parameters())
    assert all(p.grad is not None for p in model.opt.parameters())
    model.zero_grad(set_to_none=True)


def test_long_sequence_remat_sdpa_step():
    """A >= 2,048-token sequence through remat + SDPA: one finite step on
    narrow widths (JAX's test_train_step_long_seq_remat_blockwise)."""
    base = small_test_config(n_max_triangles=228)     # 228 * 9 + 2 = 2054 tokens
    cfg = dataclasses.replace(base, opt=dataclasses.replace(base.opt, max_positions=2560))
    assert cfg.generate_length >= 2048
    model = init_random_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    state, step_fn = ttrain.make_train_step(cfg, model, remat=True, block_q=256)
    batch = ttrain.make_batch(cfg, np.random.default_rng(0), batch=2, seq=cfg.generate_length)
    state, metrics = step_fn(state, *batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert state.step == 1
    assert all(p.grad is None for p in model.parameters())


def test_step_trains_with_grad_turned_off(bridged):
    """make_train_step's step runs autograd whatever the process's grad
    mode (the inference entry points turn it off): the same update as
    with grad on."""
    jcfg, _, cfg, _, batch = bridged
    out = []
    for enabled in (True, False):
        model = params_from_jax_numpy(_tree(jcfg), cfg)
        state, step_fn = ttrain.make_train_step(cfg, model, make_optimizer(1e-3, steps=5))
        with torch.set_grad_enabled(enabled):
            step_fn(state, *batch)
            step_fn(state, *batch)
        out.append(model.opt.lm_head.weight.detach().clone())
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], params_from_jax_numpy(_tree(jcfg), cfg).opt.lm_head.weight)


def test_tf32_on_card_scope():
    """The train step's f32 matmuls run as TF32 on a card and the flag is
    set back after the step; on the CPU nothing changes."""
    flag = torch.backends.cuda.matmul
    before = flag.allow_tf32
    try:
        flag.allow_tf32 = False
        with ttrain.tf32_on_card(torch.device("cpu")):
            assert not flag.allow_tf32
        with ttrain.tf32_on_card(torch.device("cuda")):
            assert flag.allow_tf32
        assert not flag.allow_tf32
    finally:
        flag.allow_tf32 = before


# ---------------------------------------------------------------------------
# optimizer


@pytest.mark.parametrize("steps", [20, None])
def test_schedule_matches_optax(steps):
    """The lr of the update at each count is optax's: warmup-cosine with
    the warmup inside the decay span (steps=20: warmup 2), or a linear
    warmup to a constant (steps=None: warmup 50); count 0 has lr 0. Held
    at rtol 1e-5: optax computes in f32, (init - end) * frac + end, the
    port in f64."""
    lr = 1e-3
    opt = make_optimizer(lr, steps=steps)
    warmup = min(50, max((steps or 500) // 10, 1))
    assert opt.warmup_steps == warmup
    if steps is None:
        ref = optax.linear_schedule(0.0, lr, warmup)
    else:
        ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, 2), lr * 0.1)
    counts = range(0, 70)
    got = np.array([opt.schedule(c) for c in counts])
    want = np.array([float(ref(c)) for c in counts])
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


LR = 1e-3            # the full-scale recipe's
GRAD_RTOL = 1e-4     # test_grads_match_jax's


@pytest.mark.parametrize("clip_norm", [10.0, 0.05])
def test_five_steps_match_jax(bridged, jax_grad_fn, clip_norm):
    """Five train steps from the same weights on the same batch: the
    parameters equal JAX's (make_optimizer(lr 1e-3, steps=20)) at rtol
    1e-5, with an atol of 5 * lr * GRAD_RTOL: adam divides each grad by
    its own scale, so a grad's relative error (GRAD_RTOL between the
    packages) becomes an error of up to lr times it in an update. The
    grad norm is ~0.4 at these weights: below the 10.0 limit (no clip)
    and above 0.05 (every update clipped). JAX's side is the body of its
    train_step, the grad compiled once for both cases and the update
    apart."""
    jcfg, jparams, cfg, _, (pc, ids, labels) = bridged
    jopt = joptim.make_optimizer(LR, steps=20, clip_norm=clip_norm)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = jparams, jopt.init(jparams)
    for _ in range(5):
        _, grads = jax_grad_fn(params, pc_normal=jnp.asarray(pc), token_ids=jnp.asarray(ids),
                               labels=jnp.asarray(labels))
        params, opt_state = update(grads, opt_state, params)
    want = _named(params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), cfg))

    model = params_from_jax_numpy(_tree(jcfg), cfg)
    tstate, step_fn = ttrain.make_train_step(cfg, model,
                                             make_optimizer(LR, steps=20, clip_norm=clip_norm))
    norms = []
    for _ in range(5):
        tstate, metrics = step_fn(tstate, pc, ids, labels)
        norms.append(float(metrics["grad_norm"]))
    assert tstate.step == 5 and tstate.opt_state.count == 5
    assert all((n > clip_norm) == (clip_norm < 1) for n in norms), norms
    for name, p in _named(model).items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(), rtol=1e-5,
                                   atol=5 * LR * GRAD_RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# losses


def test_token_losses_match_jax():
    """shifted_token_ce and token_accuracy against JAX, including an
    all-ignored batch (0, where F.cross_entropy's mean gives NaN)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 7)).astype(np.int32)
    labels[:, :3] = -100
    labels[1, 5] = -100
    ignored = np.full_like(labels, -100)
    for lab in (labels, ignored):
        for fn in ("shifted_token_ce", "token_accuracy"):
            want = float(getattr(jlosses, fn)(jnp.asarray(logits), jnp.asarray(lab)))
            got = float(getattr(losses, fn)(torch.from_numpy(logits), torch.from_numpy(lab)))
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=fn)
    assert float(losses.shifted_token_ce(torch.from_numpy(logits), torch.from_numpy(ignored))) == 0


def test_contrastive_and_psnr_match_jax():
    """The local contrastive loss and PSNR against JAX (the grouped form,
    JAX's axis_name, is held in test_torch_parallel.py)."""
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(2))
    want = float(jlosses.contrastive_loss(jnp.asarray(a), jnp.asarray(b), jnp.float32(7.0)))
    got = float(losses.contrastive_loss(torch.from_numpy(a), torch.from_numpy(b),
                                        torch.tensor(7.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(float(losses.compute_psnr(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jlosses.compute_psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


def _cube(side=1.0):
    h = side / 2
    v = np.array([[-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
                  [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]])
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
    return Mesh(v, f)


def test_vae_occupancy_loss_through_query_geometry(bridged):
    """JAX's test_vae_occupancy_loss_end_to_end path (encode -> pre_kl ->
    decode -> query_geometry -> vae_occupancy_loss) in both packages: the
    loss parts (rtol 1e-5) and every perceiver grad (rtol 1e-4, atol 1e-6)."""
    jcfg, jparams, cfg, model, _ = bridged
    pcfg = cfg.perceiver
    batch = tdata.sample_training_points(_cube(), n_surface=pcfg.num_points, n_vol=64, n_near=32,
                                         rng=np.random.default_rng(0))

    def jloss(p):
        latents = jper.encode_latents(p, jcfg.perceiver, jnp.asarray(batch.surface)[None])
        mean, logvar = jnp.split(jlinear(latents[:, 1:], p["pre_kl"]["w"], p["pre_kl"]["b"]),
                                 2, axis=-1)
        decoded = jper.decode_latents(p, jcfg.perceiver, mean)
        logits = jper.query_geometry(p, jcfg.perceiver, jnp.asarray(batch.queries)[None], decoded)
        out = jlosses.vae_occupancy_loss(logits[0], jnp.asarray(batch.occupancy), mean, logvar)
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams["perceiver"])
    full = jax.tree_util.tree_map(np.zeros_like, jax.tree_util.tree_map(np.asarray, jparams))
    full["perceiver"] = jax.tree_util.tree_map(np.asarray, jgrads)
    want = _named(params_from_jax_numpy(full, cfg).perceiver)

    p = model.perceiver
    p.zero_grad(set_to_none=True)
    with torch.enable_grad():
        latents = per.encode_latents(p, pcfg, torch.from_numpy(batch.surface)[None])
        mean, logvar = lin(latents[:, 1:], p.pre_kl).chunk(2, dim=-1)
        logits = per.query_geometry(p, pcfg, torch.from_numpy(batch.queries)[None],
                                    per.decode_latents(p, pcfg, mean))
        out = losses.vae_occupancy_loss(logits[0], torch.from_numpy(batch.occupancy), mean,
                                        logvar)
        out["loss"].backward()
    for key in ("loss", "vol_bce", "kl"):
        np.testing.assert_allclose(out[key].item(), float(jout[key]), rtol=1e-5, err_msg=key)
    for name, param in _named(p).items():
        got = torch.zeros_like(param) if param.grad is None else param.grad
        np.testing.assert_allclose(got.numpy(), want[name].detach().numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    p.zero_grad(set_to_none=True)


def test_query_geometry_blocks_match_one_block(bridged, monkeypatch):
    """query_geometry over more queries than a block: the same logits as
    one block taking them all (the blocks only bound the scores' size)."""
    _, _, cfg, model, _ = bridged
    rng = np.random.default_rng(2)
    queries = torch.from_numpy(rng.uniform(-1, 1, size=(2, 37, 3)).astype(np.float32))
    latents = torch.from_numpy(rng.normal(size=(2, cfg.perceiver.total_latents,
                                                cfg.perceiver.width)).astype(np.float32))
    with torch.no_grad():
        whole = per.query_geometry(model.perceiver, cfg.perceiver, queries, latents)
        monkeypatch.setattr(per, "QUERY_BLOCK", 8)
        blocked = per.query_geometry(model.perceiver, cfg.perceiver, queries, latents)
    assert blocked.shape == (2, 37)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), atol=1e-6, rtol=0)


def test_encode_kl_sample_statistics(bridged):
    """encode_kl_sample draws mean + std * N(0, 1) from its generator
    (random bits cannot match JAX's): over 64k draws the standardized
    noise has mean ~0 and std ~1 (5 standard errors), one seed gives one
    draw, and logvar is clamped to [-30, 20]."""
    _, _, cfg, model, _ = bridged
    p = model.perceiver
    latents = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, cfg.perceiver.num_latents, cfg.perceiver.width)).astype(np.float32))
    with torch.no_grad():
        mean, logvar = lin(latents, p.pre_kl).chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar)
        draws = torch.stack([per.encode_kl_sample(p, latents, torch.Generator().manual_seed(s))
                             for s in range(256)])
        again = per.encode_kl_sample(p, latents, torch.Generator().manual_seed(0))
        z = ((draws - mean) / std).flatten()
        assert torch.equal(again, draws[0])
        assert abs(float(z.mean())) < 5 / np.sqrt(z.numel())
        assert abs(float(z.std()) - 1) < 5 / np.sqrt(2 * z.numel())
        # a huge logvar is clamped at 20: std e^10
        p.pre_kl.bias[cfg.perceiver.embed_dim:] += 1e4
        try:
            wide = per.encode_kl_sample(p, latents, torch.Generator().manual_seed(0)) - mean
        finally:
            p.pre_kl.bias[cfg.perceiver.embed_dim:] -= 1e4
        noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(0))
        np.testing.assert_allclose(wide.numpy(), (np.exp(10.0) * noise).numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints and resume


def _all_tensors(state):
    out = {f"params/{n}": p.detach() for n, p in state.model.named_parameters()}
    out.update({f"mu/{n}": t for n, t in state.opt_state.mu.items()})
    out.update({f"nu/{n}": t for n, t in state.opt_state.nu.items()})
    return out


def test_save_restore_bit_equal(tmp_path):
    """save_train_state -> restore_train_state into a trainer built from
    other weights gives every parameter, both moments, the update count
    and the step back bit for bit; moments are matched by name (a
    checkpoint with a name the model lacks raises)."""
    cfg = small_test_config(n_max_triangles=2)
    model = init_random_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    state, step_fn = ttrain.make_train_step(cfg, model, make_optimizer(1e-3, steps=10))
    batch = ttrain.make_batch(cfg, np.random.default_rng(0), batch=2, seq=cfg.generate_length)
    for _ in range(2):
        state, _ = step_fn(state, *batch)
    ttrain.save_train_state(state, str(tmp_path / "ckpt"))

    fresh, _ = ttrain.make_train_step(
        cfg, init_random_params(cfg, torch.Generator().manual_seed(1), dtype=torch.float32),
        make_optimizer(1e-3, steps=10))
    restored = ttrain.restore_train_state(str(tmp_path / "ckpt"), fresh)
    assert (restored.step, restored.opt_state.count) == (2, 2)
    want, got = _all_tensors(state), _all_tensors(restored)
    assert set(want) == set(got)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # mu and nu differ (same shapes): a swap would show
    assert not torch.equal(state.opt_state.mu["opt.lm_head.weight"],
                           state.opt_state.nu["opt.lm_head.weight"])

    tree = torch.load(tmp_path / "ckpt" / ttrain.STATE_FILE, weights_only=True)
    tree["mu"]["not.a.parameter"] = tree["mu"].pop("opt.lm_head.weight")
    torch.save(tree, tmp_path / "ckpt" / ttrain.STATE_FILE)
    with pytest.raises(KeyError, match="names differ"):
        ttrain.restore_train_state(str(tmp_path / "ckpt"), fresh)


def test_run_training_loop_resume(tmp_path):
    """run_training: 2 steps + crash + resume to 4 equals 4 uninterrupted
    steps bit for bit (the same batch stream through
    grammar_batches(skip=2)); JAX's test_run_training_loop_resume."""
    cfg = small_test_config(n_max_triangles=4)
    kw = dict(steps=4, seed=0, log_every=0, save_every=2, device="cpu")
    ref = ttrain.run_training(cfg, ttrain.grammar_batches(cfg, 2, seed=0),
                              ckpt_dir=str(tmp_path / "a"), **kw)
    part = ttrain.run_training(cfg, ttrain.grammar_batches(cfg, 2, seed=0),
                               ckpt_dir=str(tmp_path / "b"),
                               steps=2, seed=0, log_every=0, save_every=2, device="cpu")
    assert part.step == 2
    assert [s for s, _ in ttrain._step_dirs(str(tmp_path / "b"))] == [2]
    got = ttrain.run_training(cfg, ttrain.grammar_batches(cfg, 2, seed=0, skip=2),
                              ckpt_dir=str(tmp_path / "b"), resume=True, **kw)
    assert ref.step == got.step == 4
    assert [s for s, _ in ttrain._step_dirs(str(tmp_path / "b"))] == [2, 4]
    want, have = _all_tensors(ref), _all_tensors(got)
    for key in want:
        assert torch.equal(have[key], want[key]), key


def test_main_flags_parse_as_jax(monkeypatch, tmp_path):
    """``main`` hands run_training what JAX's main hands its own for the
    same flags (plus the device, and no mesh on one process); --dp/--tp
    whose product is not the world's size raise, and --device cuda
    without a card raises."""
    import meshanything_tpu.parallel.mesh as jmesh

    seen = {}

    def capture(key):
        def run(*args, **kw):
            seen[key] = (args, kw)
        return run

    monkeypatch.setattr(jmesh, "create_mesh", lambda **kw: None)
    monkeypatch.setattr(jtrain, "run_training", capture("jax"))
    monkeypatch.setattr(ttrain, "run_training", capture("torch"))
    argv = ["--steps", "7", "--batch", "3", "--lr", "0.01", "--ckpt_dir", str(tmp_path),
            "--save_every", "2", "--seed", "5", "--log_every", "3"]
    jtrain.main(argv)
    ttrain.main(argv + ["--device", "cpu"])
    (jargs, jkw), (targs, tkw) = seen["jax"], seen["torch"]
    assert dataclasses.asdict(targs[0]) == dataclasses.asdict(jargs[1])   # cfg
    jopt, topt = jkw.pop("optimizer"), tkw.pop("optimizer")
    assert (topt.lr, topt.steps) == (0.01, 7) and jopt is not None
    assert tkw.pop("device") == torch.device("cpu")
    assert tkw.pop("mesh") is None
    assert tkw == jkw
    np.testing.assert_array_equal(next(targs[1])[1], next(jargs[2])[1])   # the batch stream
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1"):
        ttrain.main(["--dp", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# host data pipeline


def test_data_pipeline_bit_equal():
    """ray_parity_inside, sample_training_points and axis_scale_augment
    give JAX's arrays bit for bit for the same rng."""
    mesh = _cube()
    pts = np.random.default_rng(4).uniform(-0.7, 0.7, size=(300, 3))
    np.testing.assert_array_equal(tdata.ray_parity_inside(pts, mesh.vertices, mesh.faces),
                                  jdata.ray_parity_inside(pts, mesh.vertices, mesh.faces))
    kw = dict(n_surface=128, n_vol=96, n_near=64)
    got = tdata.sample_training_points(mesh, rng=np.random.default_rng(5), **kw)
    want = jdata.sample_training_points(mesh, rng=np.random.default_rng(5), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdata.axis_scale_augment(got.surface, got.queries, rng=np.random.default_rng(6)),
                    jdata.axis_scale_augment(want.surface, want.queries,
                                             rng=np.random.default_rng(6))):
        np.testing.assert_array_equal(a, b)


def _sample(rng):
    return {"surface": rng.normal(size=(2, 200, 9)),
            "vol_points": rng.normal(size=(150, 3)), "vol_label": rng.integers(0, 2, 150),
            "near_points": rng.normal(size=(120, 3)), "near_label": rng.integers(0, 2, 120)}


@pytest.mark.parametrize("spec", [
    {"RandomSample": {"num_volume_samples": 64, "num_near_samples": 32},
     "AxisScaleTransform": {}},
    {"SplitRandomSample": {"use_surface_sample": True, "num_surface_samples": 100,
                           "num_volume_samples": 64, "num_near_samples": 32}},
    {"RandomSample": {"num_volume_samples": 16, "num_near_samples": 16},
     "FeatureSelection": {"surface_feature_type": "normal"},
     "AxisScaleTransform": {"interval": (0.5, 1.5), "jitter": False}},
    None,
])
def test_transforms_bit_equal(spec):
    """build_transforms over the registry gives JAX's dicts bit for bit
    for the same sample and rng (None: the identity); an unknown name
    raises."""
    def sample():
        out = _sample(np.random.default_rng(7))
        if spec and "SplitRandomSample" in spec:    # one surface set, not a stack of them
            out["surface"] = out["surface"][0]
        return out

    got = ttransforms.build_transforms(spec)(sample(), np.random.default_rng(8))
    want = jtransforms.build_transforms(spec)(sample(), np.random.default_rng(8))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(KeyError, match="unknown transform"):
        ttransforms.build_transforms({"Nope": {}})
