"""A run with the timed path broken underneath comes out not correct: the
whole run (set-up, window, comparison) on the CPU at a small size, past
the harness's look for a card, once for each fault a cell can have, and
once for each control. The cells run on one chip, so no exchange between
chips can be left out."""
import json

import pytest
import torch

from meshanything_tpu_torch.geometry import postprocess
from meshanything_tpu_torch.models import meshanything, shape_opt
from perfbench import harness

SEED = 2 ** 31 + 3


def _run(cell, model, tier=None):
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu", model=model, tier=tier)


@pytest.mark.parametrize("cell", ["exact-b1", "exact-b16"])
def test_a_sound_run_is_correct(cell, moderate_model):
    assert _run(cell, moderate_model)["correct"] is True


CONTROLS = harness.find_cell(harness.load_benchmark(), "exact-b1")[2]["controls"]


@pytest.mark.parametrize("tier", CONTROLS, ids=[json.dumps(t) for t in CONTROLS])
def test_the_programs_lower_precision_paths_are_not_correct(tier, moderate_model):
    """Each control, the program with a lower-precision path of its own
    switched on, fails the comparison by its cache (here in float32, one
    step lower is int8 as on the card)."""
    result = _run("exact-b1", moderate_model, tier)
    assert result["correct"] is False
    assert result["check"]["cache_err"]["value"] > result["check"]["cache_err"]["limit"]


def _stale(monkeypatch):
    """A step that leaves its state unchanged: the new K/V row is not
    written."""
    def attend(state, layer_idx, write_pos, cur_len, q, k, v, group=None):
        return shape_opt.decode_attention(q, state.kv, layer_idx, cur_len)
    monkeypatch.setattr(shape_opt, "_step_attention", attend)


def _half_batch(monkeypatch):
    """Half of the batch left out: its rows decode the first half's
    condition."""
    original = meshanything.encode

    def encode(m, cfg, pc):
        half = pc.shape[0] // 2
        pf, cond = original(m, cfg, pc[:half])
        return torch.cat([pf, pf]), torch.cat([cond, cond])
    monkeypatch.setattr(meshanything, "encode", encode)


def _token_altered(monkeypatch):
    """One served token altered where the step produces it (the stream goes
    on from the altered token)."""
    original = shape_opt.step_body
    calls = [0]

    def step(p, cfg, state, **kw):
        logits = original(p, cfg, state, **kw)
        calls[0] += 1
        if calls[0] == 20:
            slot = int(state.step_t) - 1
            state.tokens[:, slot] = (state.tokens[:, slot] + 7) % cfg.vocab_size
            state.last_token.copy_(state.tokens[:, slot])
        return logits
    monkeypatch.setattr(shape_opt, "step_body", step)


def _coordinate_altered(monkeypatch):
    """An answer altered where it is produced: a face's coordinate moved."""
    original = meshanything.detokenize

    def detok(m, cfg, raw, pf):
        coords = original(m, cfg, raw, pf)
        face = int((~torch.isnan(coords[0, :, 0, 0])).nonzero()[0, 0])     # the first face made
        coords[:, face, 1, 0] = -coords[:, face, 1, 0] - 1.0 / 128
        return coords
    monkeypatch.setattr(meshanything, "detokenize", detok)


def _obj_altered(monkeypatch):
    """An answer altered where it is produced: the OBJ loses a face."""
    original = postprocess.postprocess_faces

    def post(face_coords, out_path):
        mesh = original(face_coords, out_path)
        lines = open(out_path).read().splitlines()
        last = max(i for i, line in enumerate(lines) if line.startswith("f "))
        with open(out_path, "w") as fh:
            fh.write("\n".join(lines[:last] + lines[last + 1:]) + "\n")
        return mesh
    monkeypatch.setattr(postprocess, "postprocess_faces", post)


FAULTS = [
    ("exact-b1", _stale, "decode_gap"),
    ("exact-b1", _stale, "cache_err"),
    ("exact-b16", _half_batch, "decode_gap"),
    ("exact-b1", _token_altered, "decode_gap"),
    ("exact-b1", _coordinate_altered, "detok_gap"),
    ("exact-b16", _obj_altered, "obj_faces_off"),
]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f, _ in FAULTS])
def test_a_broken_run_is_not_correct(cell, fault, number, moderate_model, monkeypatch):
    fault(monkeypatch)
    result = _run(cell, moderate_model)
    assert result["correct"] is False
    got = result["check"][number]
    assert got["value"] > got["limit"], result["check"]
