"""Nemotron-4-15B [arXiv:2402.16819] — dense GQA with squared-ReLU MLP.

32L d_model=6144 48H (GQA kv=8, d_head=128) d_ff=24576 vocab=256000.
"""
from repro_torch.models.lm import LMConfig


def config(**ov) -> LMConfig:
    base = dict(
        name="nemotron_4_15b",
        n_layers=32,
        d_model=6144,
        vocab_size=256000,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=24576,
        activation="relu2",
        norm="layernorm",
        rope_theta=10000.0,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="nemotron_smoke",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=512,
        activation="relu2",
        norm="layernorm",
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
