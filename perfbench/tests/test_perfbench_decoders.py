"""The decoder-family seam (``perfbench/decoders``): the OPT family reads
exactly as the benchmark did before the seam existed, a family added as a
file alone runs a whole dry run to ``correct``, a wrong equation in such a
family is caught, and no family's reference imports the program or JAX.

``opt_before_the_seam.json`` holds what the code before the seam gave:
the parameter specification of ``ma350m-bf16`` (names, shapes, kinds,
stds, in draw order, which fixes a seed's weights), the bytes and FLOPs of
both cells' decodes (B=1 and B=16, 7,201 steps) and of traced slices, and
the comparison's four numbers with the first sample's cache errors by
layer on ``moderate_model`` for the program and two of its lower-precision
paths (float32 on the CPU, one thread).
"""
import ast
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from meshanything_tpu_torch.geometry.postprocess import postprocess_faces
from meshanything_tpu_torch.runtime.phases import PhaseRunner
from perfbench import check, devtrace, harness, weights
from perfbench.reference import model as ref

BEFORE = json.loads((Path(__file__).parent / "opt_before_the_seam.json").read_text())
BENCH = harness.load_benchmark()
MA350M = harness.find_cell(BENCH, "exact-b1")[2]
OPT = harness.load_decoder(MA350M["decoder"])
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
TIERS = {"pallas": {"attn": "pallas"}, "pallas_int8": {"attn": "pallas_int8"},
         "pallas+wq": {"attn": "pallas", "wq": True}}


def test_the_specification_is_the_one_before_the_seam():
    got = [[name, list(shape), kind, std]
           for name, shape, kind, std in ref.param_spec(MA350M["model"], OPT)]
    assert got == BEFORE["spec"]


def test_the_counts_are_the_ones_before_the_seam():
    model = MA350M["model"]
    for batch, (nbytes, flops) in BEFORE["decode_work"].items():
        work = OPT.decode_work(model, int(batch), 7201)
        assert (work.bytes, work.flops) == (nbytes, flops)
    for key, parts in BEFORE["slice_work"].items():
        batch, p0, p1 = map(int, key.split(":"))
        sl = devtrace.Slice([], [], 0.0, 1.0, 1e-6, [p0] * batch, [p1] * batch, 2, 0)
        got = OPT.slice_work(model, batch, sl)
        assert {k: [w.bytes, w.flops] for k, w in got.items()} == parts


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("tier", sorted(TIERS))
@torch.no_grad()
def test_the_comparison_reads_as_before_the_seam(tier, moderate_model, one_thread):
    """Two meshes of the program (as configured, or with its int8 cache or
    W8A8 matrices), judged by the comparison: its four numbers and the
    first sample's cache errors by layer, to the last bit."""
    cfg, net = OPT.program(moderate_model, CPU)
    spec = ref.param_spec(moderate_model, OPT)
    iface = OPT.interface(moderate_model)
    zero = (iface["eos_row"], iface["eos"])
    weights.fill(spec, net.state_dict().__getitem__, SEED, CPU, torch.float32, zero)
    pc = torch.randn(2, cfg.perceiver.num_points, 6, generator=torch.Generator().manual_seed(SEED))
    pc[..., 3:] /= pc[..., 3:].norm(dim=-1, keepdim=True)
    runner = PhaseRunner(net, cfg, early_exit=False, attn=TIERS[tier]["attn"],
                         wq=TIERS[tier].get("wq", False))
    out = runner.run(pc)
    with tempfile.TemporaryDirectory() as tmp:
        samples = []
        for r in range(2):
            coords = out["coords"][r].float().numpy()
            path = f"{tmp}/m{r}.obj"
            postprocess_faces(coords, path)
            samples.append({"points": pc[r].numpy(), "tokens": out["tokens"][r],
                            "coords": coords, "obj": path})
        written = iface["cond_length"] + out["tokens"].shape[1] - 1
        samples[0]["cache"] = OPT.read_cache(harness._kept_state(runner), 0, written)
        W = weights.reference_params(spec, SEED, CPU, torch.float32, zero)
        profiles: list = []
        numbers = check.compare(W, moderate_model, OPT, samples, CPU, profiles)
    assert numbers == BEFORE["check"][tier]["numbers"]
    assert [list(e) for e in profiles[0]["cache"]] == BEFORE["check"][tier]["cache"]


def _family_copy(tmp_path: Path, edit=None) -> None:
    """``decoders/opt.py`` copied into ``tmp_path``, ``edit``ed: the
    configuration's family, loaded from there once ``DECODERS`` points
    at it."""
    src = (harness.DECODERS / "opt.py").read_text()
    if edit is not None:
        old, new = edit
        assert src.count(old) == 1
        src = src.replace(old, new)
    (tmp_path / "opt.py").write_text(src)


def test_a_family_added_as_a_file_runs_to_correct(tmp_path, moderate_model, monkeypatch):
    """A family that is a file in a directory the loader is pointed at and
    nothing else carries a whole dry run (set-up, window, comparison)."""
    _family_copy(tmp_path)
    monkeypatch.setattr(harness, "DECODERS", tmp_path)
    result = harness.run_cell("exact-b1", SEED, 0.3, False, device="cpu", model=moderate_model)
    assert result["correct"] is True, result["check"]


def test_a_wrong_equation_in_a_family_is_not_correct(tmp_path, moderate_model, monkeypatch):
    """The same copy with GELU in place of ReLU in its reference's MLP: the
    program's greedy tokens lie below the wrong reference's best."""
    _family_copy(tmp_path, ("x + linear(F.relu(linear(", "x + linear(F.gelu(linear("))
    monkeypatch.setattr(harness, "DECODERS", tmp_path)
    result = harness.run_cell("exact-b1", SEED, 0.3, False, device="cpu", model=moderate_model)
    assert result["correct"] is False
    got = result["check"]["decode_gap"]
    assert got["value"] > got["limit"], result["check"]


def test_an_unknown_family_fails_at_set_up(tmp_path, moderate_model, monkeypatch):
    """The configuration names a family that the loader's directory lacks."""
    monkeypatch.setattr(harness, "DECODERS", tmp_path)
    with pytest.raises(ValueError, match="no decoder family 'opt'"):
        harness.Session("exact-b1", SEED, device="cpu", model=moderate_model)


FAMILIES = sorted(p.stem for p in harness.DECODERS.glob("*.py"))
PROGRAM = "meshanything_tpu_torch"


@pytest.mark.parametrize("family", FAMILIES)
def test_a_familys_reference_imports_neither_the_program_nor_jax(family):
    """Outside ``program``, which builds the program under test, a family
    module imports nothing of the program or of ``harness.FORBIDDEN``; and
    loading it with the shared reference loads none of them."""
    tree = ast.parse((harness.DECODERS / f"{family}.py").read_text())
    inside_program = {id(n) for f in tree.body if isinstance(f, ast.FunctionDef)
                      and f.name == "program" for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)) and id(node) not in inside_program:
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
            for top in (n.split(".")[0] for n in names):
                assert top not in harness.FORBIDDEN + (PROGRAM,), (family, ast.dump(node))
    code = (f"import sys; sys.path.insert(0, {str(harness.ROOT)!r}); "
            f"from perfbench import harness, check, counts, weights; "
            f"harness.load_decoder({family!r}); "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            f"set(harness.FORBIDDEN + ({PROGRAM!r},))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_the_benchmark_reads_the_decoder_only_through_its_family():
    """Outside the families, no file of the benchmark's code names the OPT
    decoder's configuration or parameters; and the runner's private state
    is read in one place, ``harness._kept_state``, shared by every family."""
    banned = ('model["opt"]', "cfg.opt", '"opt.')
    kept = []

    def visit(path, node, fn):             # ``._kept`` read, by its innermost function
        if isinstance(node, ast.Attribute) and node.attr == "_kept":
            kept.append((path.name, fn))
        for child in ast.iter_child_nodes(node):
            visit(path, child, child.name if isinstance(child, ast.FunctionDef) else fn)

    for path in sorted(harness.PACKAGE.rglob("*.py")):
        if "tests" in path.relative_to(harness.PACKAGE).parts:
            continue
        visit(path, ast.parse(path.read_text()), None)
        if harness.DECODERS not in path.parents:
            assert not [b for b in banned if b in path.read_text()], path
    assert kept == [("harness.py", "_kept_state")]
