"""Qwen2.5-32B [hf:Qwen/Qwen2.5-*] — dense GQA with QKV bias.

64L d_model=5120 40H (GQA kv=8, d_head=128) d_ff=27648 vocab=152064.
"""
from repro_torch.models.lm import LMConfig


def config(**ov) -> LMConfig:
    base = dict(
        name="qwen2p5_32b",
        n_layers=64,
        d_model=5120,
        vocab_size=152064,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=27648,
        qkv_bias=True,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=1e6,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="qwen32b_smoke",
        n_layers=2,
        d_model=160,
        vocab_size=512,
        n_heads=5,
        n_kv_heads=1,
        d_head=32,
        d_ff=320,
        qkv_bias=True,
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
