"""internvl2-2b — InternViT + InternLM2 VLM.

[arXiv:2404.16821; hf]  Backbone: 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553.  The InternViT frontend is a STUB: ``input_specs``
provides precomputed patch embeddings (1024-d, 256 tokens/image) that a
linear projector maps into the backbone (per the assignment's
"[vlm] = backbone only" rule).
"""

from repro_torch.configs.base import FrontendConfig, LayerSpec, ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-2b",
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92_553,
        pattern=(LayerSpec(mixer="attn", ff="dense"),),
        n_periods=24,
        frontend=FrontendConfig(kind="vision", feature_dim=1024, n_positions=256),
    )
