"""Architecture registry + reduced (smoke) configs.

``get_config(arch_id)`` returns the full assigned configuration;
``get_config(arch_id, smoke=True)`` returns a reduced same-family config
(small width/depth/experts/vocab) for CPU smoke tests.  Full configs are
exercised only via the dry-run (ShapeDtypeStruct, no allocation).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    gemma2_27b,
    granite_20b,
    hubert_xlarge,
    internlm2_20b,
    internvl2_2b,
    jamba_v0p1_52b,
    kimi_k2_1t,
    mamba2_1p3b,
    minicpm_2b,
    qwen2_moe_a2p7b,
)
from repro_torch.configs.base import FrontendConfig, ModelConfig, MoEConfig, SSMConfig

__all__ = ["ARCHS", "get_config", "list_archs", "shrink"]

ARCHS = {
    "mamba2-1.3b": mamba2_1p3b.make_config,
    "jamba-v0.1-52b": jamba_v0p1_52b.make_config,
    "kimi-k2-1t-a32b": kimi_k2_1t.make_config,
    "qwen2-moe-a2.7b": qwen2_moe_a2p7b.make_config,
    "internvl2-2b": internvl2_2b.make_config,
    "granite-20b": granite_20b.make_config,
    "gemma2-27b": gemma2_27b.make_config,
    "minicpm-2b": minicpm_2b.make_config,
    "internlm2-20b": internlm2_20b.make_config,
    "hubert-xlarge": hubert_xlarge.make_config,
}


def list_archs() -> list[str]:
    return sorted(ARCHS)


def shrink(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: tiny widths, few experts, 2 periods."""
    kv = min(cfg.n_kv_heads, 4)
    heads = 4 if cfg.n_heads >= 4 else cfg.n_heads
    if heads % kv:
        kv = 1
    changes: dict = dict(
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        n_periods=min(cfg.n_periods, 2),
        max_seq_len=512,
        dtype="float32",          # CPU smoke: keep numerics tight
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_expert=32,
            d_shared=32 if cfg.moe.n_shared else 0,
            n_shared=min(cfg.moe.n_shared, 2),
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, headdim=8, expand=2, chunk=16,
        )
    if cfg.frontend is not None:
        changes["frontend"] = dataclasses.replace(
            cfg.frontend, feature_dim=32,
            n_positions=8 if cfg.frontend.n_positions else 0,
        )
    return cfg.with_(**changes)


#: vocab is padded to a multiple of this so the embedding/LM head shard
#: evenly over the TP axis (Megatron's make-vocab-size-divisible-by).
VOCAB_PAD = 128


def get_config(arch_id: str, *, smoke: bool = False, pad_vocab: bool = True,
               **overrides) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    cfg = ARCHS[arch_id]()
    if smoke:
        cfg = shrink(cfg)
    elif pad_vocab and cfg.vocab_size % VOCAB_PAD:
        cfg = cfg.with_(vocab_size=-(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD)
    if overrides:
        cfg = cfg.with_(**overrides)
    return cfg
