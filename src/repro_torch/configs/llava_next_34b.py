"""LLaVA-NeXT-34B backbone [hf:llava-hf/llava-v1.6-*] — a VLM whose anyres
patch frontend is a stub: a batch carries precomputed patch embeddings as
``prefix_embeds``, prepended to the text tokens' embeddings.

60L d_model=7168 56H (GQA kv=8, d_head=128) d_ff=20480 vocab=64000, the
same two configurations as ``repro/configs/llava_next_34b.py``.
"""
from repro_torch.models.lm import LMConfig


def config(**ov) -> LMConfig:
    base = dict(
        name="llava_next_34b",
        n_layers=60,
        d_model=7168,
        vocab_size=64000,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=20480,
        activation="swiglu",
        norm="rmsnorm",
        rope_theta=5e6,
        prefix_embed=True,
    )
    base.update(ov)
    return LMConfig(**base)


def smoke_config(**ov) -> LMConfig:
    base = dict(
        name="llava_smoke",
        n_layers=2,
        d_model=128,
        vocab_size=512,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=256,
        prefix_embed=True,
        flash_min_seq=1 << 30,
        loss_chunk=64,
    )
    base.update(ov)
    return LMConfig(**base)
