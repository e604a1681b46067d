"""internlm2-20b — dense GQA baseline.

[arXiv:2403.17297; hf]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="internlm2-20b",
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16_384,
        vocab_size=92_544,
        pattern=(LayerSpec(mixer="attn", ff="dense"),),
        n_periods=48,
    )
