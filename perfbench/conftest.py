"""pytest settings of the benchmark's own tests (``perfbench/tests``).

Tests that need an NVIDIA card carry the ``cuda`` marker and take the
``card`` fixture, which decides when the test runs, never at import, and
skips on a machine without one.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this machine has no CUDA device")
    return torch.device("cuda")


@pytest.fixture
def moderate_model():
    """Model sizes for CPU tests: the 350M model's widths (so that logits
    spread as widely: lm_head's N(0, 0.02) over hidden 1024 gives a logit
    std of 0.64) at two decoder layers, a 64-row codebook and 8 faces."""
    import dataclasses

    from meshanything_tpu_torch.config import (MeshAnythingConfig, NRDConfig, PerceiverConfig,
                                               ShapeOPTConfig)

    cfg = MeshAnythingConfig(
        perceiver=PerceiverConfig(num_latents=16, embed_dim=8, width=64, heads=4,
                                  num_encoder_layers=1, num_decoder_layers=1, num_points=64),
        opt=ShapeOPTConfig(hidden_size=1024, num_layers=2, num_heads=16, ffn_dim=4096,
                           vocab_size=67, codebook_size=64, codebook_dim=32, max_positions=512,
                           cond_length=17, cond_dim=64),
        nrd=NRDConfig(hidden_size=768, num_layers=1, num_heads=12, intermediate_size=3072,
                      codebook_dim=32, cond_length=17, cond_dim=64, max_faces_pos=256),
        n_max_triangles=8, dtype="float32")
    return dataclasses.asdict(cfg)
