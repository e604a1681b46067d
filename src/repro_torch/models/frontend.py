"""Modality frontends — STUBS per the assignment.

``[vlm]``/``[audio]`` architectures specify the transformer backbone only;
``input_specs()`` provides *precomputed* patch/frame embeddings.  The stub
is a single linear projection into the backbone width (the real InternViT /
HuBERT conv feature extractor is out of scope by design).

The port of ``repro.models.frontend``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import FrontendConfig, ModelConfig
from repro_torch.models.layers import dense, init_dense

__all__ = ["init_frontend", "apply_frontend"]


def init_frontend(gen, cfg: ModelConfig, *, device=None):
    fe: FrontendConfig = cfg.frontend
    return {"proj": init_dense(gen, fe.feature_dim, cfg.d_model,
                               getattr(torch, cfg.param_dtype), device=device)}


def apply_frontend(cfg: ModelConfig, params, features, text_embeds=None):
    """features: (B, n_positions, feature_dim) → backbone embeddings.

    For VLM the projected patch tokens are prepended to the text embeds;
    for audio they *are* the sequence.
    """
    x = dense(cfg, features, params["proj"], "bpf,fe->bpe")
    if text_embeds is not None:
        x = torch.cat([x.to(text_embeds.dtype), text_embeds], dim=1)
    return x
