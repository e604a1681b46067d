"""mamba2-1.3b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  48L d_model=2048, d_ff=0, vocab=50280,
ssm_state=128.  Pure Mamba-2: each layer is one SSD mixer, no MLP
(d_ff=0 per the assignment), tied embeddings.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-1.3b",
        d_model=2048,
        n_heads=32,           # unused (attention-free); kept for cache API
        n_kv_heads=32,
        d_ff=0,
        vocab_size=50_280,
        pattern=(LayerSpec(mixer="mamba", ff="none"),),
        n_periods=48,
        ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1,
                      conv_kernel=4, chunk=128),
        tie_embeddings=True,
        max_seq_len=1 << 20,  # state is O(1) in seq: long-context capable
    )
