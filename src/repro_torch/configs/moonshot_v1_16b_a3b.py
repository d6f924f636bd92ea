"""Moonshot-v1-16B-A3B (Kimi / Moonlight family)
[hf:moonshotai/Moonlight-16B-A3B] — MoE, 64 experts top-6; the same two
configurations as ``repro/configs/moonshot_v1_16b_a3b.py``.

48L d_model=2048 16H (kv=16, d_head=128) expert d_ff=1408 vocab=163840.
Every layer is MoE, with no shared experts, as the reference states it (the
released Moonlight also has a dense first layer and shared experts).
"""
from repro_torch.models.lm import LMConfig, MoEConfig


def config(**ov) -> LMConfig:
    n_layers = 48
    base = dict(
        name="moonshot_v1_16b_a3b",
        n_layers=n_layers,
        d_model=2048,
        vocab_size=163840,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=0,
        activation="swiglu",
        norm="rmsnorm",
        moe_layers=tuple(range(n_layers)),
        moe=MoEConfig(n_experts=64, top_k=6, d_expert_ff=1408),
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="moonshot_smoke",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        n_heads=4,
        n_kv_heads=4,
        d_head=32,
        d_ff=0,
        moe_layers=(0, 1),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=64, token_chunk=64,
                      capacity_factor=4.0),
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
