"""DeepSeek-V3-671B [arXiv:2412.19437] — MLA + MoE (1 shared + 256 routed
top-8) + multi-token prediction; the same two configurations as
``repro/configs/deepseek_v3_671b.py``.

61L d_model=7168 128H (MLA: q_lora=1536, kv_lora=512, nope=128, rope=64,
v=128) expert d_ff=2048 vocab=129280. The first 3 layers are dense
(d_ff=18432); MTP depth 1.

The port builds MLA blocks with dense MLPs; MoE layers and multi-token
prediction are not ported, so the published configuration raises when a
model is built from it. Its dense prefix builds with
``config(n_layers=3, block_types=("mla",) * 3, moe_layers=(),
mtp_depth=0)``.
"""
from repro_torch.models.lm import LMConfig, MoEConfig


def config(**ov) -> LMConfig:
    n_layers = 61
    base = dict(
        name="deepseek_v3_671b",
        n_layers=n_layers,
        d_model=7168,
        vocab_size=129280,
        n_heads=128,
        n_kv_heads=128,
        d_head=128,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        d_ff=18432,                      # dense layers (first 3)
        activation="swiglu",
        norm="rmsnorm",
        block_types=("mla",) * n_layers,
        moe_layers=tuple(range(3, n_layers)),
        moe=MoEConfig(n_experts=256, top_k=8, d_expert_ff=2048,
                      n_shared_experts=1, d_shared_ff=2048),
        mtp_depth=1,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="deepseek_smoke",
        n_layers=3,
        d_model=128,
        vocab_size=512,
        n_heads=4,
        n_kv_heads=4,
        d_head=32,
        q_lora_rank=64,
        kv_lora_rank=32,
        qk_nope_dim=32,
        qk_rope_dim=16,
        v_head_dim=32,
        d_ff=256,
        block_types=("mla",) * 3,
        moe_layers=(1, 2),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=64,
                      n_shared_experts=1, d_shared_ff=64, token_chunk=64,
                      capacity_factor=4.0),
        mtp_depth=1,
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
