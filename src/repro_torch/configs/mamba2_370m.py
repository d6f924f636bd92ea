"""Mamba2-370m [arXiv:2405.21060] — attention-free SSD (state-space
duality).

48L d_model=1024 (d_inner=2048, head_dim=64 -> 32 ssm heads, d_state=128),
no MLP (d_ff=0), vocab=50280, tied head: the two configurations of
``repro/configs/mamba2_370m.py``.
"""
from repro_torch.models.lm import LMConfig
from repro_torch.nn.mamba import SSMConfig


def config(**ov) -> LMConfig:
    base = dict(
        name="mamba2_370m",
        n_layers=48,
        d_model=1024,
        vocab_size=50280,
        d_ff=0,
        block_types=("mamba",) * 48,
        ssm=SSMConfig(d_model=1024, d_inner=2048, d_state=128, head_dim=64),
        norm="rmsnorm",
        tie_embeddings=True,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="mamba2_smoke",
        n_layers=4,
        d_model=128,
        vocab_size=512,
        d_ff=0,
        block_types=("mamba",) * 4,
        ssm=SSMConfig(d_model=128, d_inner=256, d_state=32, head_dim=32,
                      chunk=32),
        tie_embeddings=True,
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
