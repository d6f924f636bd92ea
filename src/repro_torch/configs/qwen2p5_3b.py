"""Qwen2.5-3B [hf:Qwen/Qwen2.5-*] — dense GQA with QKV bias, tied embeddings.

36L d_model=2048 16H (GQA kv=2, d_head=128) d_ff=11008 vocab=151936.
"""
from repro_torch.models.lm import LMConfig


def config(**ov) -> LMConfig:
    base = dict(
        name="qwen2p5_3b",
        n_layers=36,
        d_model=2048,
        vocab_size=151936,
        n_heads=16,
        n_kv_heads=2,
        d_head=128,
        d_ff=11008,
        qkv_bias=True,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=1e6,
        tie_embeddings=True,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="qwen3b_smoke",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=256,
        qkv_bias=True,
        tie_embeddings=True,
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
