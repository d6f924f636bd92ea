"""Llama-3.1-8B-Instruct — the paper's large evaluation model (Sec. 3.1).

32L d_model=4096 32H (GQA kv=8, d_head=128) d_ff=14336 vocab=128256,
untied head, the two configurations of ``repro/configs/llama3_8b.py``.
"""
from repro_torch.models.lm import LMConfig


def config(**ov) -> LMConfig:
    base = dict(
        name="llama3_8b",
        n_layers=32,
        d_model=4096,
        vocab_size=128256,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=5e5,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="llama8b_smoke",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=256,
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
