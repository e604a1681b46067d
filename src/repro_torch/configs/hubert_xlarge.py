"""hubert-xlarge — encoder-only audio transformer.

[arXiv:2106.07447; unverified]  48L d_model=1280 16H d_ff=5120 vocab=504
(masked-prediction codebook).  Encoder-only: bidirectional attention, no
autoregressive decode (decode shapes are N/A per the assignment).  The
wav2vec2-style conv feature extractor is a STUB — ``input_specs`` provides
precomputed 512-d frame embeddings.
"""

from repro_torch.configs.base import FrontendConfig, LayerSpec, ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="hubert-xlarge",
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        pattern=(LayerSpec(mixer="attn", ff="dense"),),
        n_periods=48,
        encoder_only=True,
        causal=False,
        mlp_act="gelu",
        frontend=FrontendConfig(kind="audio", feature_dim=512, n_positions=0),
    )
