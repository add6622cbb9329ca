"""What decides ``correct``: a sample of the window's finished meshes held
against the plain reference (``perfbench/reference``), which reads the
program's outputs only to judge them.

For each sampled mesh the reference encodes the mesh's points itself,
runs the decoder teacher-forced over the program's served tokens (the
configuration's decoder family, ``decoders/<decoder>.py``), and
detokenizes those tokens from its own point features. Four numbers:

  decode_gap     the widest gap, over every served position up to the
                 first eos, by which the served token's reference logit
                 lies below the reference's best (greedy tokens: 0 in
                 exact arithmetic). It covers the encode too, whose
                 condition every logit reads.
  detok_gap      the same for the detokenizer: the widest gap by which the
                 reference's logit of the program's coordinate bin lies
                 below its best bin, over every coordinate of every face
                 (infinite where the program's faces are not the faces the
                 tokens make).
  cache_err      the cache that the timed path wrote, read back after the
                 window (one row of the window's last request, by the
                 family's ``read_cache``): the share of the first decoder
                 layer's cached entries at the decode positions (the OPT
                 family's K and V) that lie further from the reference's
                 than CACHE_TOL of their row's root mean square. The first
                 layer's rows come from the token embedding alone, so the
                 program's own rounding stays well inside the tolerance,
                 and a cache or a K/V projection one precision step lower
                 (int8: errors up to amax / 254 of a row) does not. Deeper
                 layers carry the condition's and earlier layers' rounding,
                 and are only profiled (``profiles``).
  obj_faces_off  faces missing or extra, and vertices missing or extra, in
                 the OBJ against the clean-up of the program's face
                 coordinates (``reference/mesh.py``): exact, limit 0.

The control is the program itself with its own lower-precision path
switched on (each of the configuration's ``controls``, a set of the
runner's options), judged by the same comparison (``calibrate.py``,
``tests/test_perfbench_control.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import mesh as ref_mesh
from perfbench.reference import model as ref

NUMBERS = ("decode_gap", "detok_gap", "cache_err", "obj_faces_off")


def _served_end(tokens: torch.Tensor, eos: int) -> int:
    """Positions [0, end) were chosen greedily: through the first eos."""
    hit = (tokens == eos).nonzero()
    return int(hit[0, 0]) + 1 if len(hit) else tokens.shape[0]


def _gap(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per position: the best logit less the chosen one's."""
    return logits.max(dim=-1).values - logits.gather(-1, chosen[..., None])[..., 0]


def profile(logits: torch.Tensor, chosen: torch.Tensor) -> dict:
    """How the chosen entries sit in the reference's logits: the widest
    and the mean gap, the share of positions off the reference's best,
    and the widest reference margin (best less second best) where they are
    off."""
    gap = _gap(logits, chosen)
    top = logits.topk(2, dim=-1).values
    margin = top[..., 0] - top[..., 1]
    off = gap > 0
    return {"widest": float(gap.max()), "mean": float(gap.mean()),
            "share": float(off.float().mean()),
            "margin_off": float(margin[off].max()) if off.any() else 0.0}


def _bins(coords: np.ndarray, bins: int) -> tuple:
    c = torch.as_tensor(coords, dtype=torch.float32).reshape(coords.shape[0], 9)
    mask = ~torch.isnan(c[:, 0])
    return torch.round((c.nan_to_num(0.0) + 0.5) * bins).long(), mask


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dequantize(cache: dict) -> torch.Tensor:
    """The program's cache rows as float32: (..., n, width) values, times
    their (..., n) row scales where the cache is quantized."""
    rows = cache["values"].float()
    if cache["scales"] is not None:
        rows = rows * cache["scales"][..., None].float()
    return rows


CACHE_TOL = 0.01


class _CacheProbe:
    """The program's cache rows against the reference's (the family's
    ``decoder_logits``'s ``cache_probe``) at the decode positions [c,
    rows): ``share``, the first layer's share of entries off by more than
    CACHE_TOL of their row's RMS, and ``err``, each layer's relative error
    in norm of each part (the OPT family's K and V).

    ``cache`` is the family's ``read_cache``: a list of groups, each
    {"values": (parts, L, n, width), "scales": (parts, L, n) or None}.
    The reference hands each layer's rows in the same groups: a tuple of
    (C + T - 1, width) tensors a group, one a part."""

    def __init__(self, cache: list, c: int, rows: int, device: torch.device):
        self.cache, self.c, self.rows, self.device = cache, c, rows, device
        self.err: list = []
        self.share = math.inf

    def __call__(self, layer: int, groups: list) -> None:
        span = slice(self.c, self.rows)
        err, off_entries = [], []
        for stored, parts in zip(self.cache, groups, strict=True):
            got = dequantize({"values": stored["values"][:, layer, span],
                              "scales": None if stored["scales"] is None
                              else stored["scales"][:, layer, span]}).to(self.device)
            want = torch.stack([part[span] for part in parts])
            off = got - want
            err += [float(off[p].norm() / want[p].norm()) for p in range(len(parts))]
            if layer == 0:
                rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
                off_entries.append((off.abs() > CACHE_TOL * rms).flatten())
        self.err.append(tuple(err))
        if layer == 0:
            self.share = float(torch.cat(off_entries).float().mean())


@torch.no_grad()
def compare(W: dict, model: dict, decoder, samples: List[dict], device: torch.device,
            profiles: Optional[list] = None) -> Dict[str, float]:
    """The four numbers over ``samples``, each {"points": (N, 6) float32,
    "tokens": (T,) int64, "coords": (faces, 3, 3) float32, "obj": path},
    the first also "cache" (the decoder family's ``read_cache``: its row
    of the program's cache); ``profiles`` receives each sample's
    ``profile`` of tokens and bins, and the first's cache errors by
    layer."""
    _no_tf32()
    iface = decoder.interface(model)
    eos, c = iface["eos"], iface["cond_length"]
    bins = model["nrd"]["discrete_num"]
    out = {"decode_gap": 0.0, "detok_gap": 0.0, "cache_err": math.inf, "obj_faces_off": 0}
    for s in samples:
        toks = s["tokens"].to(device)
        pf, cond = ref.encode(W, model, torch.as_tensor(s["points"], device=device))
        end = _served_end(toks, eos)
        probe = None
        if s.get("cache") is not None:
            probe = _CacheProbe(s["cache"], c, c + end - 1, device)
        logits = decoder.decoder_logits(W, model, cond, toks, probe)
        out["decode_gap"] = max(out["decode_gap"], float(_gap(logits[:end], toks[:end]).max()))
        if probe is not None:
            out["cache_err"] = probe.share
        if profiles is not None:
            profiles.append({"decode": profile(logits[:end], toks[:end])})
            if probe is not None:
                profiles[-1]["cache"] = probe.err
        del logits
        dl, mask = ref.detok_logits(W, model, pf, toks, iface["codebook"])
        chosen, pmask = _bins(s["coords"], bins)
        if not torch.equal(pmask.to(device), mask):
            out["detok_gap"] = math.inf
        elif mask.any():
            gap = _gap(dl[mask], chosen.to(device)[mask])
            out["detok_gap"] = max(out["detok_gap"], float(gap.max()))
            if profiles is not None:
                profiles[-1]["detok"] = profile(dl[mask], chosen.to(device)[mask])
        out["obj_faces_off"] += ref_mesh.faces_off(s["coords"], s["obj"])
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and no mesh failed. A number that could not be read (the
    comparison raised) fails, and is null in the table, which stays JSON."""
    table = {name: {"value": numbers[name], "limit": limits[name]} for name in NUMBERS}
    table["failed_meshes"] = {"value": failed, "limit": 0}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    for v in table.values():
        if not math.isfinite(v["value"]):
            v["value"] = None
    return ok, table


def sample_rows(requests: List[dict], pairs: list) -> List[dict]:
    """The sampled (request, row) pairs' inputs and outputs."""
    rows = []
    for req, row in pairs:
        r = requests[req]
        rows.append({"points": r["points"][row], "tokens": r["tokens"][row],
                     "coords": r["coords"][row], "obj": r["objs"][row]})
    return rows


def limits_of(config: dict) -> Dict[str, float]:
    lim = config["limits"]
    missing = [n for n in NUMBERS if n not in lim]
    if missing:
        raise ValueError(f"configuration {config.get('name')!r} has no limit for {missing}")
    return {n: float(lim[n]) for n in NUMBERS}
