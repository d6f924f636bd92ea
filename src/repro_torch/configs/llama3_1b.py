"""Llama-3.2-1B-Instruct — the paper's small evaluation model (Sec. 3.1).

16L d_model=2048 32H (GQA kv=8, d_head=64) d_ff=8192 vocab=128256, the same
three configurations as ``repro/configs/llama3_1b.py``.
"""
from repro_torch.models.lm import LMConfig


def config(**ov) -> LMConfig:
    base = dict(
        name="llama3_1b",
        n_layers=16,
        d_model=2048,
        vocab_size=128256,
        n_heads=32,
        n_kv_heads=8,
        d_head=64,
        d_ff=8192,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=5e5,
        tie_embeddings=True,
    )
    base.update(ov)
    return LMConfig(**base)


def bench_config(**ov) -> LMConfig:
    """Reduced stand-in keeping the llama block structure (~4M params)."""
    base = dict(
        name="llama3_bench",
        n_layers=6,
        d_model=192,
        vocab_size=2048,
        n_heads=6,
        n_kv_heads=2,
        d_head=32,
        d_ff=768,
        activation="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
        flash_min_seq=1 << 30,
        loss_chunk=128,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="llama3_smoke",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=256,
        tie_embeddings=True,
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
