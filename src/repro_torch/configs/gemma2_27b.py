"""gemma2-27b — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]  46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000, head_dim=128, sliding window 4096 on alternating layers,
attention softcap 50, final-logit softcap 30, tied embeddings.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma2-27b",
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        d_ff=36_864,
        vocab_size=256_000,
        head_dim=128,
        pattern=(
            LayerSpec(mixer="attn", ff="dense", window=4096),  # local
            LayerSpec(mixer="attn", ff="dense", window=None),  # global
        ),
        n_periods=23,
        attn_softcap=50.0,
        final_softcap=30.0,
        tie_embeddings=True,
    )
