"""Hymba-1.5B [arXiv:2411.13676] — hybrid parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5, d_head=64) d_ff=5504 vocab=32001,
ssm_state=16. Every layer runs attention and mamba heads in parallel on the
shared input norm; layers use a 1024-token sliding window except the three
global-attention layers 0, 15 and 31. As in ``repro/configs/hymba_1p5b.py``,
meta-tokens and cross-layer KV sharing are not modeled.
"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.mamba import SSMConfig


def config(**ov) -> LMConfig:
    d_model = 1600
    base = dict(
        name="hymba_1p5b",
        n_layers=32,
        d_model=d_model,
        vocab_size=32001,
        n_heads=25,
        n_kv_heads=5,
        d_head=64,
        d_ff=5504,
        activation="swiglu",
        norm="rmsnorm",
        sliding_window=1024,
        global_attn_layers=(0, 15, 31),
        block_types=("hybrid",) * 32,
        ssm=SSMConfig(d_model=d_model, d_inner=2 * d_model, d_state=16,
                      head_dim=64),
        tie_embeddings=True,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="hymba_smoke",
        n_layers=4,
        d_model=128,
        vocab_size=512,
        n_heads=5,
        n_kv_heads=1,
        d_head=16,
        d_ff=256,
        activation="swiglu",
        sliding_window=32,
        global_attn_layers=(0,),
        block_types=("hybrid",) * 4,
        ssm=SSMConfig(d_model=128, d_inner=256, d_state=16, head_dim=32),
        tie_embeddings=True,
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
