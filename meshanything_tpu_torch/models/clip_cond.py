"""CLIP conditional encoders: the port of ``meshanything_tpu/models/clip_cond.py``
(the reference's conditional_encoders tier,
michelangelo/models/conditional_encoders/encoder_factory.py):

  * ``CLIPTextTower`` — the HF CLIP text tower (FrozenCLIPTextEmbedder,
    :38-108): ``text_embedding`` is its last_hidden_state; the empty
    string is the unconditional embedding;
  * ``CLIPVisionTower`` — the HF CLIP vision tower behind
    FrozenCLIPImageEmbedder (:185-296: resize-224 / center-crop / CLIP
    mean-std, image features, L2-normalized, optional zero dropout) and
    FrozenCLIPImageGridEmbedder (:299-379: every vision token);
  * ``ClassEmbedder`` (:23-35).

The towers mirror the JAX parameter tree name for name: the q/k/v
projections packed into one ``qkv`` linear, and the patch embedding a
linear over each patch unfolded in (row, col, channel) order, as JAX
unfolds it (the HF conv ``(D, 3, p, p)`` is transposed to match by
``convert_clip_vision``). The weights come from an HF CLIPModel state dict
of numpy arrays through ``convert_clip_text`` / ``convert_clip_vision``
(no ``transformers`` needed). ``preprocess_image`` resizes with JAX's
``jax.image.resize`` semantics (``resize_weights``), not
``F.interpolate``'s.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from meshanything_tpu_torch.models.layers import (
    _merge_heads,
    _split_heads,
    attention,
    lin,
    ln,
)
from meshanything_tpu_torch.runtime.checkpoint import _lin, _ln, _stack, fill_from_jax_numpy


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    max_positions: int = 77
    projection_dim: int = 768
    ln_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    projection_dim: int = 768
    ln_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


# ---------------------------------------------------------------------------
# the towers


class CLIPLayer(nn.Module):
    """HF CLIPEncoderLayer: pre-LN attention + pre-LN quickGELU MLP."""

    def __init__(self, width: int, heads: int, eps: float, *, causal: bool, device=None,
                 dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        self.heads = heads
        self.causal = causal
        self.ln1 = nn.LayerNorm(width, eps=eps, **f)
        self.qkv = nn.Linear(width, 3 * width, **f)
        self.out = nn.Linear(width, width, **f)
        self.ln2 = nn.LayerNorm(width, eps=eps, **f)
        self.fc1 = nn.Linear(width, 4 * width, **f)
        self.fc2 = nn.Linear(4 * width, width, **f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.heads
        q, k, v = lin(ln(x, self.ln1), self.qkv).chunk(3, dim=-1)
        o = attention(_split_heads(q, h), _split_heads(k, h), _split_heads(v, h),
                      causal=self.causal)
        x = x + lin(_merge_heads(o), self.out)
        return x + lin(quick_gelu(lin(ln(x, self.ln2), self.fc1)), self.fc2)


class CLIPTextTower(nn.Module):
    """HF CLIPTextModel (+ text_projection) over padded (B, 77) ids with the
    causal mask (the reference passes no attention mask,
    encoder_factory.py:97)."""

    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.width, **f))
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_positions, cfg.width, **f))
        self.layers = nn.ModuleList(CLIPLayer(cfg.width, cfg.heads, cfg.ln_eps, causal=True, **f)
                                    for _ in range(cfg.layers))
        self.ln_final = nn.LayerNorm(cfg.width, eps=cfg.ln_eps, **f)
        self.text_projection = nn.Linear(cfg.width, cfg.projection_dim, bias=False, **f)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (last_hidden_state (B, N, D), pooled (B, D)): pooled is the
        token at the first ``eos_token_id`` after the final LN (HF)."""
        b, n = input_ids.shape
        x = self.token_embedding[input_ids] + self.position_embedding[:n]
        for layer in self.layers:
            x = layer(x)
        x = ln(x, self.ln_final)
        eos_pos = (input_ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        return x, x[torch.arange(b, device=x.device), eos_pos]

    def features(self, input_ids: torch.Tensor) -> torch.Tensor:
        """get_text_features: pooled @ text_projection."""
        return lin(self(input_ids)[1], self.text_projection)


class CLIPVisionTower(nn.Module):
    """HF CLIPVisionModel (+ visual_projection) over (B, 3, H, W)
    normalized pixels."""

    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype=None):
        super().__init__()
        f = {"device": device, "dtype": dtype}
        p = cfg.patch_size
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.empty(cfg.width, **f))
        self.patch_embedding = nn.Linear(p * p * 3, cfg.width, bias=False, **f)
        self.position_embedding = nn.Parameter(torch.empty(1 + cfg.num_patches, cfg.width, **f))
        self.pre_ln = nn.LayerNorm(cfg.width, eps=cfg.ln_eps, **f)
        self.layers = nn.ModuleList(CLIPLayer(cfg.width, cfg.heads, cfg.ln_eps, causal=False,
                                              **f) for _ in range(cfg.layers))
        self.post_ln = nn.LayerNorm(cfg.width, eps=cfg.ln_eps, **f)
        self.visual_projection = nn.Linear(cfg.width, cfg.projection_dim, bias=False, **f)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (last_hidden_state (B, 1+P, D), pooled (B, D)): pooled is the
        post-LN class token."""
        b, p = pixel_values.shape[0], self.cfg.patch_size
        gh = self.cfg.image_size // p
        # the conv of stride = kernel = p as unfold + matmul, (row, col, channel) order
        patches = pixel_values.permute(0, 2, 3, 1).reshape(b, gh, p, gh, p, 3)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gh, p * p * 3)
        x = lin(patches, self.patch_embedding)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.position_embedding
        x = ln(x, self.pre_ln)
        for layer in self.layers:
            x = layer(x)
        return x, ln(x[:, 0], self.post_ln)

    def features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """get_image_features: pooled @ visual_projection."""
        return lin(self(pixel_values)[1], self.visual_projection)


# ---------------------------------------------------------------------------
# preprocessing (torchvision transform parity, encoder_factory.py:209-218)

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5 (jax.image's "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


RESIZE_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """The (in, out) f32 weights of one axis of ``jax.image.resize``
    (``scale_and_translate`` with translation 0, antialias on): half-pixel
    sample positions; when downsampling the kernel widened by 1/scale;
    each column renormalized to sum 1 (so the border taps are reweighted);
    a sample outside the input gets no weight."""
    kernel = RESIZE_KERNELS[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_image(image: torch.Tensor, out_h: int, out_w: int, method: str) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, out_h, out_w) as ``jax.image.resize``: two
    products with the separable weights (an axis whose size is kept is
    left as it is, as JAX skips it)."""
    _, _, h, w = image.shape
    if h != out_h:
        wh = torch.from_numpy(resize_weights(h, out_h, method)).to(image.device, image.dtype)
        image = torch.einsum("bchw,hH->bcHw", image, wh)
    if w != out_w:
        ww = torch.from_numpy(resize_weights(w, out_w, method)).to(image.device, image.dtype)
        image = torch.einsum("bchw,wW->bchW", image, ww)
    return image


def preprocess_image(image: torch.Tensor, image_size: int = 224,
                     value_range: Optional[Tuple[float, float]] = (-1.0, 1.0),
                     method: str = "cubic") -> torch.Tensor:
    """(B, 3, H, W) -> resized (shortest side to ``image_size``),
    center-cropped, CLIP-normalized pixels. ``method``: "cubic" for the
    pooled embedder's BICUBIC transform (encoder_factory.py:211), "linear"
    for the grid embedder's BILINEAR one (:324)."""
    if value_range is not None:
        lo, hi = value_range
        image = (image - lo) / (hi - lo)
    _, _, h, w = image.shape
    short = min(h, w)
    new_h, new_w = int(round(h * image_size / short)), int(round(w * image_size / short))
    image = resize_image(image, new_h, new_w, method)
    top, left = (new_h - image_size) // 2, (new_w - image_size) // 2
    image = image[:, :, top:top + image_size, left:left + image_size]
    mean = torch.from_numpy(CLIP_MEAN).to(image.device)[None, :, None, None]
    std = torch.from_numpy(CLIP_STD).to(image.device)[None, :, None, None]
    return (image - mean) / std


# ---------------------------------------------------------------------------
# embedder wrappers (the encoder_factory surface)


def _zero_drop(z: torch.Tensor, radio: float, generator: Optional[torch.Generator]):
    """Whole samples zeroed with probability ``radio`` (a draw from
    ``generator``); nothing drawn without one."""
    if radio > 0 and generator is not None:
        keep = torch.rand((z.shape[0], 1, 1), generator=generator, device=z.device) >= radio
        z = z * keep.to(z.dtype)
    return z


def text_embedding(tower: CLIPTextTower, input_ids: torch.Tensor) -> torch.Tensor:
    """FrozenCLIPTextEmbedder.forward: the full last_hidden_state
    (B, 77, D) (encoder_factory.py:83-100)."""
    return tower(input_ids)[0]


def image_embedding(tower: CLIPVisionTower, image: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    value_range: Optional[Tuple[float, float]] = (-1.0, 1.0),
                    zero_embedding_radio: float = 0.0, normalize: bool = True) -> torch.Tensor:
    """FrozenCLIPImageEmbedder.forward (encoder_factory.py:261-285): the
    pooled projected feature, L2-normalized, (B, 1, D), with the optional
    whole-sample zero dropout."""
    z = tower.features(preprocess_image(image, tower.cfg.image_size, value_range))
    if normalize:
        z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    return _zero_drop(z[:, None, :], zero_embedding_radio, generator)


def image_grid_embedding(tower: CLIPVisionTower, image: torch.Tensor, *,
                         generator: Optional[torch.Generator] = None,
                         value_range: Optional[Tuple[float, float]] = (-1.0, 1.0),
                         zero_embedding_radio: float = 0.0) -> torch.Tensor:
    """FrozenCLIPImageGridEmbedder: every vision token (B, 1+P, D)
    (encoder_factory.py:299-379), resized BILINEAR."""
    pixels = preprocess_image(image, tower.cfg.image_size, value_range, method="linear")
    return _zero_drop(tower(pixels)[0], zero_embedding_radio, generator)


def unconditional_text_ids(cfg: CLIPTextConfig, batch: int, bos: int = 49406,
                           device=None) -> torch.Tensor:
    """Token ids of the empty string: [bos, eos, eos...] — the reference's
    unconditional embedding (encoder_factory.py:78-81)."""
    ids = torch.full((batch, cfg.max_positions), cfg.eos_token_id, dtype=torch.long,
                     device=device)
    ids[:, 0] = bos
    return ids


TEMPLATES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "templates.json")


def load_text_templates(category: str = "shape") -> list:
    """CLIP prompt-ensemble templates (the reference's
    miche/michelangelo/data/templates.json; the port's own copy): the raw
    ``"a photo of a {}."``-style format strings."""
    with open(TEMPLATES) as fh:
        return list(json.load(fh)[category])


def expand_text_templates(label: str, category: str = "shape") -> list:
    """One class label filled into every template."""
    return [t.format(label) for t in load_text_templates(category)]


# ---------------------------------------------------------------------------
# HF CLIPModel state dict (numpy arrays) -> the towers


def _clip_layers(sd: Mapping, prefix: str, layers: int) -> dict:
    def one(i):
        lp = f"{prefix}.layers.{i}."
        parts = [f"{lp}self_attn.{n}_proj" for n in ("q", "k", "v")]
        return {
            "ln1": _ln(sd, lp + "layer_norm1"),
            "qkv": {"w": np.concatenate([np.asarray(sd[p + ".weight"]).T for p in parts], axis=1),
                    "b": np.concatenate([np.asarray(sd[p + ".bias"]) for p in parts])},
            "out": _lin(sd, lp + "self_attn.out_proj"),
            "ln2": _ln(sd, lp + "layer_norm2"),
            "fc1": _lin(sd, lp + "mlp.fc1"),
            "fc2": _lin(sd, lp + "mlp.fc2"),
        }

    return _stack([one(i) for i in range(layers)])


def clip_text_tree(sd: Mapping, cfg: CLIPTextConfig, prefix: str = "text_model.") -> dict:
    """HF text keys -> JAX's parameter tree (``convert_clip_text`` of the
    JAX package, in numpy)."""
    g = lambda k: prefix + k  # noqa: E731
    return {
        "token_embedding": np.asarray(sd[g("embeddings.token_embedding.weight")]),
        "position_embedding": np.asarray(sd[g("embeddings.position_embedding.weight")]),
        "layers": _clip_layers(sd, g("encoder"), cfg.layers),
        "ln_final": _ln(sd, g("final_layer_norm")),
        "text_projection": _lin(sd, "text_projection"),
    }


def clip_vision_tree(sd: Mapping, cfg: CLIPVisionConfig, prefix: str = "vision_model.") -> dict:
    """HF vision keys -> JAX's parameter tree: the conv (D, 3, p, p) as the
    unfold-matmul weight (p*p*3, D), (row, col, channel) order."""
    g = lambda k: prefix + k  # noqa: E731
    conv = np.asarray(sd[g("embeddings.patch_embedding.weight")])
    d, c, ph, pw = conv.shape
    return {
        "class_embedding": np.asarray(sd[g("embeddings.class_embedding")]),
        "patch_embedding": {"w": np.ascontiguousarray(conv.transpose(2, 3, 1, 0)
                                                      .reshape(ph * pw * c, d))},
        "position_embedding": np.asarray(sd[g("embeddings.position_embedding.weight")]),
        "pre_ln": _ln(sd, g("pre_layrnorm")),   # HF's typo'd attribute name
        "layers": _clip_layers(sd, g("encoder"), cfg.layers),
        "post_ln": _ln(sd, g("post_layernorm")),
        "visual_projection": _lin(sd, "visual_projection"),
    }


def convert_clip_text(sd: Mapping, cfg: CLIPTextConfig, prefix: str = "text_model.", *,
                      device=None, dtype=torch.float32) -> CLIPTextTower:
    """An HF CLIPModel state dict of numpy arrays -> ``CLIPTextTower``
    (q/k/v packed)."""
    return fill_from_jax_numpy(CLIPTextTower(cfg, device=device or "cpu", dtype=dtype),
                               clip_text_tree(sd, cfg, prefix))


def convert_clip_vision(sd: Mapping, cfg: CLIPVisionConfig, prefix: str = "vision_model.", *,
                        device=None, dtype=torch.float32) -> CLIPVisionTower:
    """An HF CLIPModel state dict of numpy arrays -> ``CLIPVisionTower``."""
    return fill_from_jax_numpy(CLIPVisionTower(cfg, device=device or "cpu", dtype=dtype),
                               clip_vision_tree(sd, cfg, prefix))


# ---------------------------------------------------------------------------
# class-label conditioning (encoder_factory.py:23-35)


class ClassEmbedder(nn.Module):
    """ClassEmbedder: (B,) int labels -> (B, 1, D) cross-attention tokens;
    the table N(0, 0.02) at init."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, *,
                 generator: Optional[torch.Generator] = None, device=None, dtype=None):
        super().__init__()
        self.embedding = nn.Embedding(n_classes, embed_dim, device=device, dtype=dtype)
        with torch.no_grad():
            self.embedding.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.embedding(labels)[:, None]
