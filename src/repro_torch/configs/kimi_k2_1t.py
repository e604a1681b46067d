"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8)
d_ff=2048 (per expert) vocab=163840, MoE 384e top-8 + 1 shared expert;
first layer dense (DeepSeek-V3-style).  The assignment specifies GQA
(the real model uses MLA — noted in DESIGN.md).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="kimi-k2-1t-a32b",
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=18_432,          # the single dense (first) layer
        vocab_size=163_840,
        prefix=(LayerSpec(mixer="attn", ff="dense"),),
        pattern=(LayerSpec(mixer="attn", ff="moe"),),
        n_periods=60,
        head_dim=112,
        moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                      n_shared=1, d_shared=2048),
    )
