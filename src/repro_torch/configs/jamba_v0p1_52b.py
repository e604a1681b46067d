"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2.  Period of 8 layers: attention at position 4,
Mamba elsewhere; MoE replaces the MLP on every other layer.

Adaptation note (DESIGN.md): Jamba v0.1 uses Mamba-1 mixers; we use the
SSD (Mamba-2) form — the chunked-batched-GEMM evaluation the paper's
primitive accelerates — with Jamba's d_state=16.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, SSMConfig


def make_config() -> ModelConfig:
    pattern = tuple(
        LayerSpec(
            mixer="attn" if i == 4 else "mamba",
            ff="moe" if i % 2 == 1 else "dense",
        )
        for i in range(8)
    )
    return ModelConfig(
        arch_id="jamba-v0.1-52b",
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14_336,
        vocab_size=65_536,
        pattern=pattern,
        n_periods=4,
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14_336),
        ssm=SSMConfig(d_state=16, headdim=64, expand=2, n_groups=1,
                      conv_kernel=4, chunk=128),
        max_seq_len=1 << 20,
    )
