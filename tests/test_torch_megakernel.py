"""K5 in the PyTorch port (``attn="megakernel"``): the plain whole-step
version against the JAX package's megakernel (Pallas, interpret mode) on
bridged weights, poisoned rows past cur_len, the packer, the megakernel
path end to end against JAX, the refusals, and the kernel itself where a
card is present."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshanything_tpu.config import small_test_config as jax_small_config
from meshanything_tpu.models import meshanything as jma
from meshanything_tpu.models import shape_opt as jsopt
from meshanything_tpu.ops.megakernel import _pack_small_params
from meshanything_tpu.ops.megakernel import decode_step_megakernel as jax_decode_step_megakernel
from meshanything_tpu.runtime.pipeline import InferencePipeline as JaxPipeline
from meshanything_tpu.runtime.pipeline import load_inputs as jax_load_inputs
from meshanything_tpu_torch.config import small_test_config
from meshanything_tpu_torch.models import decoding
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import shape_opt as opt
from meshanything_tpu_torch.ops.megakernel import (
    decode_step_megakernel,
    decode_step_megakernel_reference,
    pack_megakernel_layers,
    row_group,
    smem_plan,
    split_plan,
    tile_rows,
)
from meshanything_tpu_torch.ops.decode_attention import FoldWorkspace, fold_group, split_bounds
from meshanything_tpu_torch.runtime.checkpoint import params_from_jax_numpy
from meshanything_tpu_torch.runtime.pipeline import InferencePipeline, load_inputs

# tests/test_megakernel.py's depth at small_test_config's widths (D 32,
# H 4, head_dim 8, F 64)
LAYERS = 3
S, CHUNK = 64, 16
# f32: the same math in another summation order; bf16: one rounding of the
# O(1) outputs (and of the written K/V rows) to bf16
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the kernel against the plain version on the card: the two also differ in
# summation order, so now and then a product's input rounds to the other
# bf16 neighbour (up to ~1e-3 over these layers on the H100)
CARD_TOL = {"float32": 5e-3, "bfloat16": 3e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _configs(n_max_triangles=4, layers=LAYERS):
    jcfg, cfg = jax_small_config(n_max_triangles), small_test_config(n_max_triangles)
    return (dataclasses.replace(jcfg, opt=dataclasses.replace(jcfg.opt, num_layers=layers)),
            dataclasses.replace(cfg, opt=dataclasses.replace(cfg.opt, num_layers=layers)))


def _tree(jcfg, seed=0):
    """The JAX parameter tree as numpy, with random biases and LayerNorm
    affines in the decoder layers (JAX's init leaves them 0 and 1)."""
    tree = jax.tree_util.tree_map(
        np.array, jma.init_meshanything_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    layers = tree["opt"]["layers"]
    for name in ("qkv", "out", "fc1", "fc2"):
        layers[name]["b"] = (rng.normal(size=layers[name]["b"].shape) * 0.1).astype(np.float32)
    for name in ("ln_attn", "ln_ffn"):
        shape = layers[name]["scale"].shape
        layers[name]["scale"] = (1 + rng.normal(size=shape) * 0.1).astype(np.float32)
        layers[name]["bias"] = (rng.normal(size=shape) * 0.1).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = _configs()
    tree = _tree(jcfg)
    model = params_from_jax_numpy(tree, cfg)
    return jcfg, cfg, tree, model, pack_megakernel_layers(model.opt.layers)


def _step_inputs(seed, batch, d, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, d)).astype(np.float32)
    kv = (rng.normal(size=(2, LAYERS, batch, S, d)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":   # round once, so both packages see the same values
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        kv = np.array(jnp.asarray(kv, jnp.bfloat16).astype(jnp.float32))
    return x, kv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,write_pos", [(1, 21), (2, 21), (2, 0), (1, S - 1)])
def test_plain_step_matches_jax_megakernel(bridged, dtype, batch, write_pos):
    """(a) x_out and the written K/V rows within TOL of the JAX kernel in
    interpret mode; every other cache row bit-identical to the input."""
    jcfg, cfg, tree, _, packed = bridged
    d, h, eps = cfg.opt.hidden_size, cfg.opt.num_heads, cfg.opt.ln_eps
    tdt, jdt = DTYPES[dtype]
    x, kv = _step_inputs(batch * 100 + write_pos, batch, d, dtype)
    jlayers = jax.tree_util.tree_map(jnp.asarray, tree["opt"]["layers"])
    jx, jkv = jax_decode_step_megakernel(jnp.asarray(x, jdt), jlayers, jnp.asarray(kv, jdt),
                                         write_pos, write_pos + 1, num_heads=h, chunk=CHUNK,
                                         ln_eps=eps, interpret=True)
    kv_t = torch.from_numpy(kv).to(tdt)
    got = decode_step_megakernel(torch.from_numpy(x).to(tdt), packed, kv_t, write_pos,
                                 write_pos + 1, num_heads=h, ln_eps=eps)
    assert got.dtype == tdt and got.shape == (batch, d)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jx, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(kv_t[:, :, :, write_pos].float().numpy(),
                               np.asarray(jkv[:, :, :, write_pos], np.float32), atol=tol, rtol=tol)
    others = np.arange(S) != write_pos
    np.testing.assert_array_equal(kv_t.float().numpy()[:, :, :, others], kv[:, :, :, others])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_past_cur_len_does_not_reach_the_output(bridged, dtype):
    """(b) NaN in every row past cur_len, in every layer, leaves x_out
    and the written rows bit-identical."""
    _, cfg, _, _, packed = bridged
    d, h = cfg.opt.hidden_size, cfg.opt.num_heads
    tdt = DTYPES[dtype][0]
    write_pos = 30
    x, kv = _step_inputs(5, 2, d, dtype)
    clean = torch.from_numpy(kv).to(tdt)
    poisoned = clean.clone()
    poisoned[:, :, :, write_pos + 1:] = float("nan")
    xt = torch.from_numpy(x).to(tdt)
    a = decode_step_megakernel(xt, packed, clean, write_pos, write_pos + 1, num_heads=h)
    b = decode_step_megakernel(xt, packed, poisoned, write_pos, write_pos + 1, num_heads=h)
    assert torch.isfinite(a).all()
    assert torch.equal(a, b)
    assert torch.equal(clean[:, :, :, :write_pos + 1], poisoned[:, :, :, :write_pos + 1])


def test_generate_megakernel_matches_jax_tokens(bridged, monkeypatch):
    """(c) decoding.generate(attn="megakernel"), f32, B=2: greedy tokens
    identical to JAX's through each row's first eos, every step through
    the K5 wrapper."""
    jcfg, cfg, tree, model, _ = bridged
    calls = []
    real = opt.decode_step_megakernel
    monkeypatch.setattr(opt, "decode_step_megakernel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(3)
    cond = (rng.normal(size=(2, cfg.opt.cond_length, cfg.opt.hidden_size)) * 0.5
            ).astype(np.float32)
    n = 16
    want = np.asarray(jsopt.generate(jax.tree_util.tree_map(jnp.asarray, tree["opt"]), jcfg.opt,
                                     jnp.asarray(cond), max_new_tokens=n, bucket=16,
                                     attn="megakernel"))
    with torch.no_grad():
        got = decoding.generate(model.opt, cfg.opt, torch.from_numpy(cond), max_new_tokens=n,
                                bucket=16, attn="megakernel").numpy()
    assert len(calls) > 0
    for row in range(2):
        eos = np.where(want[row] == cfg.opt.eos_token_id)[0]
        limit = (eos[0] + 1) if len(eos) else n
        np.testing.assert_array_equal(got[row, :limit], want[row, :limit], err_msg=f"row={row}")


def test_pipeline_megakernel_writes_the_jax_pipelines_obj_bytes(tmp_path):
    """(d) InferencePipeline(attn="megakernel") against the JAX
    InferencePipeline(attn="megakernel") on the same bridged weights and
    input file: the same OBJ bytes."""
    jcfg = jax_small_config(n_max_triangles=4)
    cfg = small_test_config(n_max_triangles=4)
    params = jma.init_meshanything_params(jax.random.PRNGKey(42), jcfg)
    tree = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(8)
    pc = rng.normal(size=(200, 6)) * 0.3
    pc[:, 3:] /= np.linalg.norm(pc[:, 3:], axis=-1, keepdims=True)
    npy = tmp_path / "mouse.npy"
    np.save(npy, pc.astype(np.float32))

    jres = JaxPipeline(params, jcfg, batch_size=1, bucket=16, attn="megakernel").run(
        jax_load_inputs("pc_normal", [str(npy)], num_points=64, seed=0), str(tmp_path / "jax"),
        seed=0)
    pipe = InferencePipeline(params_from_jax_numpy(tree, cfg), cfg, batch_size=1, bucket=16,
                             attn="megakernel")
    res = pipe.run(load_inputs("pc_normal", [str(npy)], num_points=64, seed=0),
                   str(tmp_path / "port"), seed=0)
    assert len(res) == 1 and res[0]["faces_generated"] == jres[0]["faces_generated"] > 0
    assert res[0]["decode_steps"] == cfg.generate_length - 1
    assert open(res[0]["obj_path"], "rb").read() == open(jres[0]["obj_path"], "rb").read()


@pytest.mark.parametrize("case", ["generate_wq", "pipeline_wq", "pipeline_lookahead",
                                  "meshanything_lookahead"])
def test_megakernel_refuses_wq_and_lookahead(bridged, case):
    """(e) wq raises as in JAX; lookahead raises "not ported" (JAX's window
    loop has no megakernel path and runs its XLA tier there)."""
    jcfg, cfg, tree, model, _ = bridged
    cond = torch.zeros((1, cfg.opt.cond_length, cfg.opt.hidden_size))
    if case == "generate_wq":
        with pytest.raises(ValueError, match="wq"):
            jsopt.generate(jax.tree_util.tree_map(jnp.asarray, tree["opt"]), jcfg.opt,
                           jnp.asarray(cond.numpy()), max_new_tokens=4, bucket=16,
                           attn="megakernel", wq=True)
        with pytest.raises(ValueError, match="wq"):
            decoding.generate(model.opt, cfg.opt, cond, max_new_tokens=4, bucket=16,
                              attn="megakernel", wq=True)
    elif case == "pipeline_wq":
        with pytest.raises(ValueError, match="wq"):
            InferencePipeline(model, cfg, attn="megakernel", wq=True)
    elif case == "pipeline_lookahead":
        with pytest.raises(NotImplementedError, match="not ported"):
            InferencePipeline(model, cfg, attn="megakernel", lookahead=4)
    else:
        pc = torch.zeros((1, cfg.perceiver.num_points, 6))
        with pytest.raises(NotImplementedError, match="not ported"), torch.no_grad():
            ma.generate(model, cfg, pc, bucket=16, attn="megakernel", lookahead=4)


def test_packer_matches_the_jax_layer_leaves(bridged):
    """(f) The packed matrices are the JAX leaves transposed to (L, out,
    in) and cast to bf16 (as JAX's decode_step_megakernel casts them); the vectors are
    the f32 rows of JAX's ``_pack_small_params``."""
    jcfg, cfg, tree, _, packed = bridged
    d, f = cfg.opt.hidden_size, cfg.opt.ffn_dim
    layers = tree["opt"]["layers"]
    for name in ("qkv", "out", "fc1", "fc2"):
        got = getattr(packed, f"{name}_w")
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        want = np.asarray(jnp.asarray(layers[name]["w"]).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), want.transpose(0, 2, 1))
    small = np.asarray(_pack_small_params(jax.tree_util.tree_map(jnp.asarray, layers), d, f))
    rows = {"qkv_b": small[:, 0, :3 * d], "out_b": small[:, 0, 3 * d:4 * d],
            "fc1_b": small[:, 1, :f], "fc2_b": small[:, 2, :d],
            "ln_attn_w": small[:, 2, d:2 * d], "ln_attn_b": small[:, 2, 2 * d:3 * d],
            "ln_ffn_w": small[:, 2, 3 * d:4 * d], "ln_ffn_b": small[:, 3, :d]}
    for name, want in rows.items():
        got = getattr(packed, name)
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert packed.shape == (LAYERS, d, f)


@pytest.mark.parametrize("case,err", [("x_rank", ValueError), ("cache_shape", ValueError),
                                      ("write_pos", ValueError), ("cur_len", ValueError),
                                      ("dtype", TypeError), ("heads", ValueError),
                                      ("device", ValueError)])
def test_wrapper_refuses_bad_arguments(bridged, case, err):
    _, cfg, _, _, packed = bridged
    d, h = cfg.opt.hidden_size, cfg.opt.num_heads
    x = torch.zeros((2, d))
    kv = torch.zeros((2, LAYERS, 2, S, d))
    pos, cur = 3, 4
    if case == "x_rank":
        x = x[None]
    elif case == "cache_shape":
        kv = torch.zeros((2, LAYERS, 1, S, d))
    elif case == "write_pos":
        pos = S
    elif case == "cur_len":
        cur = 0
    elif case == "dtype":
        x, kv = x.half(), kv.half()
    elif case == "heads":
        h = 5
    else:
        x, kv = x.to("meta"), kv.to("meta")
        packed = dataclasses.replace(packed, **{
            f.name: getattr(packed, f.name).to("meta") for f in dataclasses.fields(packed)})
    with pytest.raises(err):
        decode_step_megakernel(x, packed, kv, pos, cur, num_heads=h)


@pytest.mark.parametrize("batch,cur_len,blocks", [(1, 1, 132), (1, 300, 132), (1, 7459, 132),
                                                  (16, 7459, 132), (16, 257, 132), (3, 70, 64)])
def test_split_plan_covers_the_live_rows(batch, cur_len, blocks):
    """The attention phase's (b, split) tasks: whole ring tiles, no empty
    split, the splits cover exactly [0, cur_len), about one task a block,
    folded in K1's groups."""
    for dtype in (torch.bfloat16, torch.float32):
        tile = tile_rows(dtype)
        nsplit, group = split_plan(batch, cur_len, blocks, tile)
        bounds = split_bounds(cur_len, tile, nsplit)
        assert bounds[0][0] == 0 and bounds[-1][1] == cur_len
        assert all(a < b and a % tile == 0 for a, b in bounds)
        assert all(b0 == a1 for (_, b0), (a1, _) in zip(bounds, bounds[1:]))
        assert batch * nsplit <= max(blocks, batch) and group == fold_group(nsplit)
    assert (tile_rows(torch.bfloat16), tile_rows(torch.float32)) == (8, 4)


@pytest.mark.parametrize("batch,group", [(1, 1), (2, 2), (3, 16), (4, 16), (8, 16), (16, 16),
                                         (17, 16), (24, 16), (40, 16)])
def test_row_group_covers_the_batch(batch, group):
    """B=1 and B=2 run instances of their own size, every other B groups
    of 16 (the last one partly filled), within the H100's 227 KB of shared
    memory a block at the 350M width."""
    assert row_group(batch) == group
    groups = -(-batch // group)
    assert (groups - 1) * group < batch <= groups * group
    assert smem_plan(group, 1024, 4096, 132).total <= 232448


@pytest.mark.parametrize("group,hidden,ffn,blocks,want", [
    # (weight buffer, activations, partial sums, ring depth, total) as the kernel's note gives them
    (16, 1024, 4096, 132, (66048, 33024, 16384, 4, 197120)),
    (2, 1024, 4096, 132, (66048, 16512, 0, 4, 197120)),
    (1, 1024, 4096, 132, (66048, 8320, 0, 4, 197120)),
    (16, 32, 64, 132, (256, 1280, 16384, 4, 18176)),
])
def test_smem_plan_per_instance(group, hidden, ffn, blocks, want):
    """K5's shared memory a block: two weight buffers of a block's largest
    share (32 fc1 rows of 2,064 bytes at the 350M width), the staged input
    (D columns a pass for G = 16), the tensor-core tasks' sums, and the
    attention ring over buffer 0 and what follows it, every region 128-byte
    aligned; the ring never reaches past the launch's bytes."""
    plan = smem_plan(group, hidden, ffn, blocks)
    assert (plan.weight_buffer, plan.activations, plan.partial_sums, plan.ring_depth,
            plan.total) == want
    assert plan.weight_buffer % 128 == 0 and plan.activations % 128 == 0
    assert plan.ring_slot == 2 * tile_rows(torch.bfloat16) * hidden * 2
    assert plan.weight_buffer + plan.ring_depth * plan.ring_slot <= plan.total <= 232448
    share = -(-4 * hidden // blocks) if ffn == 4 * hidden else None
    if share is not None:
        assert plan.weight_buffer >= share * (2 * hidden + 16)


def test_smem_plan_refuses_what_does_not_fit():
    """Over too few blocks a share of fc2 outgrows a block's 227 KB."""
    with pytest.raises(ValueError, match="shared memory"):
        smem_plan(16, 1024, 4096, 8)


@pytest.mark.parametrize("batch,cur_len", [(1, 7459), (16, 7459), (24, 300)])
def test_fold_workspace_holds_the_k5_fold(batch, cur_len):
    """K5's fold uses the stream's FoldWorkspace as K1 does: the partials
    of every (b, split) and group slot, H heads of head_dim values and
    their (max, sum) pairs, fit the buffer, and the ticket counters of a
    batch row and its groups fit the counters."""
    heads, hd = 16, 64
    nsplit, group = split_plan(batch, cur_len, 132, tile_rows(torch.bfloat16))
    ws = FoldWorkspace(torch.device("cpu"))
    o_part, ml_part, counters = ws.pointers(batch, nsplit, group, heads, hd)
    slots = nsplit + -(-nsplit // group)
    assert ml_part - o_part == 4 * batch * slots * heads * hd
    assert ws.partials.numel() >= batch * slots * heads * (hd + 2)
    assert ws.counters.numel() >= batch * (1 + -(-nsplit // group))
    assert counters == ws.counters.data_ptr() and bool((ws.counters == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 4, 5, 8, 18])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(bridged, dtype, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, cfg, _, _, packed = bridged
    d, h = cfg.opt.hidden_size, cfg.opt.num_heads
    tdt = DTYPES[dtype][0]
    packed = dataclasses.replace(packed, **{
        f.name: getattr(packed, f.name).cuda() for f in dataclasses.fields(packed)})
    x, kv = _step_inputs(9, batch, d, dtype)
    xt = torch.from_numpy(x).to(tdt).cuda()
    for write_pos in (0, 21, S - 1):
        kv_k = torch.from_numpy(kv).to(tdt).cuda()
        kv_p = kv_k.clone()
        before = decode_step_megakernel.launches
        got = decode_step_megakernel(xt, packed, kv_k, write_pos, write_pos + 1, num_heads=h)
        torch.cuda.synchronize()
        assert decode_step_megakernel.launches == before + 1
        want = decode_step_megakernel_reference(xt, packed, kv_p, write_pos, write_pos + 1,
                                                num_heads=h)
        tol = CARD_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(kv_k.float(), kv_p.float(), atol=tol, rtol=tol)



@pytest.mark.parametrize("variant", ["kernel", "no_barriers", "no_weight_prefetch",
                                     "no_weight_loads", "no_gemv", "no_attention", "no_fold",
                                     "barriers_ln_only", "ln_only", "empty"])
def test_k5_breakdown_variants_apply_to_the_kernel(variant):
    """Every variant of tools/k5_breakdown.py applies to the current
    csrc/megakernel.cu and only turns kCut* constants on: the kernel
    itself has every one of them off."""
    import os
    import re

    from meshanything_tpu_torch.ops import _build
    from meshanything_tpu_torch.tools.k5_breakdown import VARIANTS, variant_source

    with open(os.path.join(_build.CSRC_DIR, "megakernel.cu")) as fh:
        source = fh.read()
    cuts = re.findall(r"constexpr bool (kCut\w+) = (\w+);", source)
    assert cuts and all(value == "false" for _, value in cuts)
    changed = variant_source(source, variant)
    on = set(re.findall(r"constexpr bool (kCut\w+) = true;", changed))
    assert on == {old.split()[2] for old, _ in VARIANTS[variant]}
    assert re.sub(r"= (true|false);", "", changed) == re.sub(r"= (true|false);", "", source)
