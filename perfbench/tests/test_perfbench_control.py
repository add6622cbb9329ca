"""On the card, at each cell's own size: each control (the program with a
lower-precision path of its own switched on) comes out not correct, and
the program correct, on three seeds. Every reading is printed before any
is judged."""
import json

import pytest

from perfbench import calibrate

SEEDS = (3_000_000_011, 3_000_000_029, 3_000_000_041)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["exact-b1", "exact-b16"])
def test_controls_fail_where_the_program_passes(card, workload):
    wrong = []
    for seed in SEEDS:
        for label, tier in calibrate.tiers(workload, "all"):
            got = calibrate.readings(workload, seed, tier)
            print(json.dumps({"workload": workload, "seed": seed, "tier": label, **got}),
                  flush=True)
            if got["correct"] is not (tier is None):
                wrong.append((seed, label, got["numbers"]))
    assert not wrong, wrong
