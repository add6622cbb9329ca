"""The plain reference against the port on the CPU, in float32 at a small
size, with the OPT decoder family (its logits against the port's OPT
``forward_full``): the condition, the teacher-forced logits and the
detokenizer agree,
the served streams are the reference's greedy choices, the cache the
program wrote is the reference's K and V, and the mesh clean-up reference
reads the program's OBJs as equal."""
import numpy as np
import pytest
import torch

from meshanything_tpu_torch.geometry.postprocess import postprocess_faces
from meshanything_tpu_torch.models import meshanything as ma
from meshanything_tpu_torch.models import shape_opt as opt_mod
from meshanything_tpu_torch.runtime.phases import PhaseRunner
from perfbench import check, harness, weights
from perfbench.reference import mesh as ref_mesh
from perfbench.reference import model as ref

CPU = torch.device("cpu")
OPT = harness.load_decoder("opt")


def _setup(model, seed=5):
    cfg, net = OPT.program(model, CPU)
    spec = ref.param_spec(model, OPT)
    iface = OPT.interface(model)
    weights.fill(spec, net.state_dict().__getitem__, seed, CPU, torch.float32,
                 (iface["eos_row"], iface["eos"]))
    W = weights.reference_params(spec, seed, CPU, torch.float32, (iface["eos_row"], iface["eos"]))
    g = torch.Generator().manual_seed(seed)
    pc = torch.randn(2, cfg.perceiver.num_points, 6, generator=g)
    pc[..., 3:] /= pc[..., 3:].norm(dim=-1, keepdim=True)
    return cfg, net, W, pc


@torch.no_grad()
def test_reference_equals_the_port_in_float32(moderate_model):
    cfg, net, W, pc = _setup(moderate_model)
    iface = OPT.interface(moderate_model)
    pf_p, cond_p = ma.encode(net, cfg, pc)
    toks = torch.randint(0, iface["vocab_size"], (cfg.generate_length,),
                         generator=torch.Generator().manual_seed(1))
    for b in range(2):
        pf, cond = ref.encode(W, moderate_model, pc[b])
        assert (pf - pf_p[b]).abs().max() < 1e-5 and (cond - cond_p[b]).abs().max() < 1e-5
        want = opt_mod.forward_full(net.opt, cfg.opt, cond_p[b:b + 1], toks[None, :-1])[0]
        got = OPT.decoder_logits(W, moderate_model, cond, toks)
        assert (got - want[cfg.cond_length - 1:]).abs().max() < 1e-4
    coords = ma.detokenize(net, cfg, toks[None], pf_p[:1])[0]
    logits, mask = ref.detok_logits(W, moderate_model, pf_p[0], toks, iface["codebook"])
    bins, pmask = check._bins(coords.numpy(), cfg.nrd.discrete_num)
    assert torch.equal(mask, pmask) and torch.equal(logits.argmax(-1)[mask], bins[mask])


@torch.no_grad()
def test_served_streams_and_cache_are_the_references(moderate_model):
    """The served tokens and coordinates read a gap of 0 to rounding, and
    the KV cache read back from the runner the reference's K and V."""
    cfg, net, W, pc = _setup(moderate_model)
    iface = OPT.interface(moderate_model)
    runner = PhaseRunner(net, cfg, early_exit=False, attn="pallas")
    out = runner.run(pc)
    for b in range(2):
        pf, cond = ref.encode(W, moderate_model, pc[b])
        toks = out["tokens"][b]
        end = check._served_end(toks, iface["eos"])
        written = iface["cond_length"] + toks.shape[0] - 1
        probe = check._CacheProbe(OPT.read_cache(harness._kept_state(runner), b, written),
                                  cfg.cond_length, written, CPU)
        logits = OPT.decoder_logits(W, moderate_model, cond, toks, probe)[:end]
        assert check._gap(logits, toks[:end]).max() < 1e-4
        assert len(probe.err) == cfg.opt.num_layers and max(map(max, probe.err)) < 1e-5
        assert probe.share == 0
        dl, mask = ref.detok_logits(W, moderate_model, pf, toks, iface["codebook"])
        bins, pmask = check._bins(out["coords"][b].float().numpy(), cfg.nrd.discrete_num)
        assert torch.equal(mask, pmask)
        if mask.any():
            assert check._gap(dl[mask], bins[mask]).max() < 1e-4


def test_quantized_cache_rows_read_back_as_their_codes_times_scales():
    values = torch.tensor([[[[[-127, 0, 64]]]]], dtype=torch.int8).expand(2, 1, 1, 1, 3)
    scales = torch.tensor([[[[0.5]]]]).expand(2, 1, 1, 1)
    got = check.dequantize({"values": values.reshape(2, 1, 1, 3),
                            "scales": scales.reshape(2, 1, 1)})
    assert torch.equal(got[0, 0, 0], torch.tensor([-63.5, 0.0, 32.0]))


def test_mesh_reference_reads_the_programs_objs(tmp_path):
    rng = np.random.default_rng(3)
    coords = (rng.integers(0, 6, (40, 3, 3)) / 128 - 0.5).astype(np.float32)
    coords[5] = coords[4]                       # a duplicate face
    coords[6, 1] = coords[6, 0]                 # a degenerate one
    coords[7:9] = np.nan                        # unfilled slots
    path = str(tmp_path / "m.obj")
    postprocess_faces(coords, path)
    assert ref_mesh.faces_off(coords, path) == 0
    lines = open(path).read().splitlines()
    last_face = max(i for i, line in enumerate(lines) if line.startswith("f "))
    with open(path, "w") as fh:
        fh.write("\n".join(lines[:last_face] + lines[last_face + 1:]) + "\n")
    assert ref_mesh.faces_off(coords, path) == 1
