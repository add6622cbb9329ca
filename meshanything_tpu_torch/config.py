"""Configuration dataclasses for the PyTorch port.

Field for field the same as ``meshanything_tpu/config.py`` (the JAX
package's configuration, which the port cannot import: that module
imports ``jax.numpy``). All defaults reproduce the shipped 350M model.

``MoonlightConfig`` is the port's second shape decoder, which the JAX
package does not have: Moonlight-16B-A3B's DeepSeek-V3 blocks behind
MeshAnything's token interface (``models/moonlight.py``).
``MeshAnythingConfig.opt`` holds whichever decoder config is chosen (the
decoder's ``decoder`` names it); both give the fields the shared code reads
there: ``hidden_size``, ``vocab_size``, the codebook's, ``face_per_token``,
``cond_length``, ``cond_dim`` and the special ids.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    """Michelangelo aligned shape-latent perceiver
    (MeshAnything/miche/shapevae-256.yaml:5-19)."""

    num_latents: int = 256          # latent tokens (+1 shape embed token)
    embed_dim: int = 64             # VAE bottleneck width
    point_feats: int = 3            # per-point normals
    num_freqs: int = 8              # Fourier frequencies
    include_pi: bool = False
    width: int = 768
    heads: int = 12
    num_encoder_layers: int = 8
    num_decoder_layers: int = 16
    use_ln_post: bool = True
    qkv_bias: bool = False
    init_scale: float = 0.25
    num_points: int = 4096          # input point-cloud size contract (main.py:24)
    ln_eps: float = 1e-5            # torch.nn.LayerNorm default

    @property
    def total_latents(self) -> int:
        # one shape-embed token is prepended (sal_perceiver.py:332)
        return self.num_latents + 1

    @property
    def fourier_dim(self) -> int:
        # include_input=True: d * (2*num_freqs + 1)  (embedder.py:81-85)
        return 3 * (2 * self.num_freqs + 1)


@dataclasses.dataclass(frozen=True)
class ShapeOPTConfig:
    """The OPT-350M-based autoregressive shape decoder: post-layernorm
    blocks, ReLU FFN, no final stack layernorm."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    vocab_size: int = 8195          # codebook 8192 + bos/eos/pad
    max_positions: int = 18259
    pos_offset: int = 2             # OPTLearnedPositionalEmbedding offset
    do_layer_norm_before: bool = False
    activation: str = "relu"
    ln_eps: float = 1e-5
    codebook_size: int = 8192
    codebook_dim: int = 1024
    face_per_token: int = 9         # 3 vertices x 3 coords
    cond_length: int = 257
    cond_dim: int = 768
    bos_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 2
    decoder = "opt"                 # the decoder family (not a field)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_face_pos(self) -> int:
        return self.face_per_token + 3


@dataclasses.dataclass(frozen=True)
class MoonlightConfig:
    """Moonlight-16B-A3B as MeshAnything's shape decoder
    (https://huggingface.co/moonshotai/Moonlight-16B-A3B, ``config.json``,
    ``model_type`` deepseek_v3): pre-RMSNorm blocks, multi-head latent
    attention with no query compression, RoPE on the 64-wide parts, one
    dense SiLU-gated layer, then layers of 64 routed experts (top 6 by
    sigmoid score plus a correction bias, weights from the score alone,
    normalised and scaled) beside 2 shared experts. The vocabulary,
    codebook, condition and special ids are MeshAnything's, as in
    ``ShapeOPTConfig``; positions are rotary, so there is no table."""

    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264      # the dense layers' MLP
    moe_intermediate_size: int = 1408   # one routed expert
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    n_group: int = 1
    topk_group: int = 1
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    vocab_size: int = 8195
    codebook_size: int = 8192
    codebook_dim: int = 1024
    face_per_token: int = 9
    cond_length: int = 257
    cond_dim: int = 768
    bos_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 2
    decoder = "moonlight"           # the decoder family (not a field)

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_width(self) -> int:
        """Values a latent-cache row holds: the normalised latent, then the
        rotated shared rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def num_face_pos(self) -> int:
        return self.face_per_token + 3

    @property
    def num_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace


@dataclasses.dataclass(frozen=True)
class NRDConfig:
    """Noise-resistant token->coordinate decoder (BERT-base, 6 layers)."""

    hidden_size: int = 768
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 3072
    ln_eps: float = 1e-12           # BERT layernorm eps
    discrete_num: int = 128         # coordinate bins
    codebook_dim: int = 1024
    cond_length: int = 257
    cond_dim: int = 768
    max_faces_pos: int = 18000
    pad_id: int = -1


@dataclasses.dataclass(frozen=True)
class MeshAnythingConfig:
    """Top-level composition (MeshAnything/models/meshanything.py:82-123)."""

    perceiver: PerceiverConfig = dataclasses.field(default_factory=PerceiverConfig)
    # the shape decoder's config: ShapeOPTConfig or MoonlightConfig
    opt: ShapeOPTConfig = dataclasses.field(default_factory=ShapeOPTConfig)
    nrd: NRDConfig = dataclasses.field(default_factory=NRDConfig)
    n_max_triangles: int = 800
    num_quantizers: int = 3
    dtype: str = "bfloat16"

    @property
    def decoder(self) -> str:
        """The shape decoder's family: "opt" or "moonlight"."""
        return self.opt.decoder

    @property
    def face_per_token(self) -> int:
        return self.num_quantizers * 3

    @property
    def cond_length(self) -> int:
        return self.opt.cond_length

    @property
    def max_length(self) -> int:
        # n_max_triangles * 9 + bos + eos + cond  (meshanything.py:93)
        return self.n_max_triangles * self.face_per_token + 2 + self.cond_length

    @property
    def generate_length(self) -> int:
        return self.max_length - self.cond_length

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def small_test_config(n_max_triangles: int = 8) -> MeshAnythingConfig:
    """A tiny config for CPU tests: same wiring, small dims."""
    return MeshAnythingConfig(
        perceiver=PerceiverConfig(
            num_latents=16, embed_dim=8, width=48, heads=4,
            num_encoder_layers=2, num_decoder_layers=2, num_points=64,
        ),
        opt=ShapeOPTConfig(
            hidden_size=32, num_layers=2, num_heads=4, ffn_dim=64,
            vocab_size=67, codebook_size=64, codebook_dim=32,
            max_positions=512, cond_length=17, cond_dim=48,
        ),
        nrd=NRDConfig(
            hidden_size=40, num_layers=2, num_heads=4, intermediate_size=80,
            codebook_dim=32, cond_length=17, cond_dim=48, max_faces_pos=256,
        ),
        n_max_triangles=n_max_triangles,
        dtype="float32",
    )


def small_moonlight_config(n_max_triangles: int = 8) -> MeshAnythingConfig:
    """``small_test_config`` with a tiny Moonlight-shaped decoder: hidden
    64, 4 heads, latent 32, nope / rope / v 16 / 8 / 16, one dense layer and
    two layers of 8 routed experts (top 2) beside 2 shared ones."""
    base = small_test_config(n_max_triangles)
    o = base.opt
    return dataclasses.replace(base, opt=MoonlightConfig(
        hidden_size=64, num_layers=3, num_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96, moe_intermediate_size=24,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2, first_k_dense_replace=1,
        max_position_embeddings=512, vocab_size=o.vocab_size, codebook_size=o.codebook_size,
        codebook_dim=o.codebook_dim, cond_length=o.cond_length, cond_dim=o.cond_dim))
