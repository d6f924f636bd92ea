"""Whisper-base [arXiv:2212.04356] — the encoder-decoder backbone, its conv
frontend stubbed (a batch carries precomputed frame embeddings).

6L enc + 6L dec, d_model=512 8H (kv=8, d_head=64) d_ff=2048 vocab=51865,
the same two configurations as ``repro/configs/whisper_base.py``.
"""
from repro_torch.models.encdec import EncDecConfig


def config(**ov) -> EncDecConfig:
    base = dict(
        name="whisper_base",
        n_enc_layers=6,
        n_dec_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_head=64,
        d_ff=2048,
        vocab_size=51865,
        activation="gelu",
        norm="layernorm",
    )
    base.update(ov)
    return EncDecConfig(**base)


def smoke_config(**ov) -> EncDecConfig:
    base = dict(
        name="whisper_smoke",
        n_enc_layers=2,
        n_dec_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        activation="gelu",
        norm="layernorm",
        flash_min_seq=1 << 30,
    )
    base.update(ov)
    return EncDecConfig(**base)
