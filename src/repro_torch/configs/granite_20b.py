"""granite-20b — code model, MQA (kv=1).

[arXiv:2405.04324; hf]  52L d_model=6144 48H (GQA kv=1 → multi-query)
d_ff=24576 vocab=49152.  GPT-BigCode lineage → GELU MLP; single KV head
exercises the broadcast (lo=0) batching path of the paper's primitive.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-20b",
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24_576,
        vocab_size=49_152,
        pattern=(LayerSpec(mixer="attn", ff="dense"),),
        n_periods=52,
        mlp_act="gelu",
    )
