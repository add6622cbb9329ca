"""On the card, at ``moon-b1``'s own size (Moonlight-16B-A3B whole, 800
faces): the program as configured comes out correct and its ``wq`` control
(the attention projections and the dense and shared MLPs as W8A8) not
correct (the comparison fails, or the routing replay refuses its
choices), on three seeds; and the program with a fault planted in its
expert path not correct on one: the expert kernel's last slot dropped (as
``test_perfbench_moonlight.py`` plants it on the CPU), and one that the
CPU's moderate size cannot show, the routing weights taken from score plus
bias. Every reading is printed before any is judged."""
import json

import pytest
import torch

from meshanything_tpu_torch.models import moonlight
from perfbench import calibrate

SEEDS = (3_000_000_011, 3_000_000_029, 3_000_000_041)


@pytest.mark.cuda
def test_the_wq_control_fails_where_the_program_passes(card):
    wrong = []
    for seed in SEEDS:
        for label, tier in calibrate.tiers("moon-b1", "all"):
            try:
                got = calibrate.readings("moon-b1", seed, tier)
            except ValueError as err:  # the routing replay refused the choices: not correct
                got = {"correct": False, "raised": str(err)}
            print(json.dumps({"workload": "moon-b1", "seed": seed, "tier": label, **got}),
                  flush=True)
            if got["correct"] is not (tier is None):
                wrong.append((seed, label, got.get("numbers", got.get("raised"))))
    assert not wrong, wrong


def _drop_last_slot(monkeypatch):
    """The expert kernel's call with its last chosen slot weighted 0."""
    kernel = moonlight.routed_experts

    def dropped(x, ids, weights, *a, **kw):
        weights = weights.clone()
        weights[:, -1] = 0.0
        return kernel(x, ids, weights, *a, **kw)
    monkeypatch.setattr(moonlight, "routed_experts", dropped)


def _weights_by_choice(monkeypatch):
    """A router whose weights are the chosen experts' score plus bias (the
    choice's key) in place of the score alone."""
    def route(gate, cfg, h):
        scores = torch.nn.functional.linear(h.float(), gate.weight.float()).sigmoid()
        choice = scores + gate.e_score_correction_bias
        ids = choice.topk(cfg.num_experts_per_tok, dim=-1).indices
        weights = choice.gather(-1, ids)
        return ids, weights / weights.sum(-1, keepdim=True) * cfg.routed_scaling_factor
    monkeypatch.setattr(moonlight, "route", route)


CARD_FAULTS = {"last slot dropped": _drop_last_slot,
               "weights by score plus bias": _weights_by_choice}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", CARD_FAULTS)
def test_a_fault_in_the_expert_path_is_not_correct_at_the_published_size(fault, card,
                                                                         monkeypatch):
    CARD_FAULTS[fault](monkeypatch)
    try:
        got = calibrate.readings("moon-b1", SEEDS[0])
    except ValueError as err:          # the routing replay refused the program's choices
        print(json.dumps({"workload": "moon-b1", "fault": fault, "raised": str(err)}), flush=True)
        return
    print(json.dumps({"workload": "moon-b1", "fault": fault, **got}), flush=True)
    assert got["correct"] is False, got["numbers"]
