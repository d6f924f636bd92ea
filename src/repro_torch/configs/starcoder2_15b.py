"""StarCoder2-15B [arXiv:2402.19173] — dense GQA, RoPE, GELU, LayerNorm.

40L d_model=6144 48H (GQA kv=4, d_head=128) d_ff=24576 vocab=49152.
"""
from repro_torch.models.lm import LMConfig


def config(**ov) -> LMConfig:
    base = dict(
        name="starcoder2_15b",
        n_layers=40,
        d_model=6144,
        vocab_size=49152,
        n_heads=48,
        n_kv_heads=4,
        d_head=128,
        d_ff=24576,
        activation="gelu",
        norm="layernorm",
        rope_theta=1e5,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="starcoder2_smoke",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        n_heads=4,
        n_kv_heads=1,
        d_head=32,
        d_ff=512,
        activation="gelu",
        norm="layernorm",
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
