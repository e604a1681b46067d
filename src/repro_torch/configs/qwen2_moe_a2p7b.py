"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H (kv=16, i.e. MHA)
d_ff=1408 per expert, vocab=151936, MoE 60e top-4.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen2-moe-a2.7b",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=151_936,
        pattern=(LayerSpec(mixer="attn", ff="moe"),),
        n_periods=24,
        moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                      n_shared=4, d_shared=1408),
    )
