"""minicpm-2b — llama-like dense model trained with the WSD schedule.

[arXiv:2404.06395; hf]  40L d_model=2304 36H (kv=36, MHA) d_ff=5760
vocab=122753, tied embeddings.  The WSD (warmup-stable-decay) learning-rate
schedule lives in ``repro.training.optimizer`` and is selected by this
arch's training preset.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        arch_id="minicpm-2b",
        d_model=2304,
        n_heads=36,
        n_kv_heads=36,
        d_ff=5760,
        vocab_size=122_753,
        pattern=(LayerSpec(mixer="attn", ff="dense"),),
        n_periods=40,
        tie_embeddings=True,
    )
