"""Model configuration schema shared by all assigned architectures.

A copy of the JAX package's ``configs/base.py`` (which imports
``jax.numpy``) with two changes: :meth:`ModelConfig.activation_dtype`
returns a ``torch.dtype``, and ``contract_backend`` takes the port's
backend names, ``"torch"`` (the default, the JAX package's ``"xla"``) and
``"kernel"`` (its ``"pallas"``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

__all__ = ["LayerSpec", "MoEConfig", "SSMConfig", "FrontendConfig", "ModelConfig"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern."""

    mixer: Literal["attn", "mamba"] = "attn"
    ff: Literal["dense", "moe", "none"] = "dense"
    window: int | None = None  # sliding-window size for local attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 1024          # per-expert FFN hidden size
    n_shared: int = 0             # shared (always-on) experts
    d_shared: int = 0             # hidden size of the shared expert block
    capacity_factor: float = 1.25
    router_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    kind: Literal["vision", "audio"] = "vision"
    #: dim of the precomputed patch/frame embeddings the stub consumes
    feature_dim: int = 1024
    #: tokens contributed by the frontend (patches per image / frames)
    n_positions: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    #: layer structure: ``prefix`` runs once, then ``pattern`` × n_periods
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    n_periods: int = 1
    prefix: tuple[LayerSpec, ...] = ()
    head_dim: int | None = None          # defaults to d_model // n_heads
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    frontend: FrontendConfig | None = None
    encoder_only: bool = False           # bidirectional, no decode step
    causal: bool = True
    mlp_act: Literal["swiglu", "gelu"] = "swiglu"
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    attn_softcap: float | None = None    # gemma2: 50.0
    final_softcap: float | None = None   # gemma2: 30.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"              # activation/param compute dtype
    param_dtype: str = "float32"         # master parameter dtype
    #: paper integration: which contraction strategy/backend model matmuls use
    contract_strategy: str = "auto"
    contract_backend: str = "torch"
    #: MoE dispatch implementation: "gshard" (one-hot einsum, GSPMD
    #: baseline) or "a2a" (shard_map fixed-capacity all-to-all — the
    #: production EP path, §Perf hillclimb)
    moe_impl: str = "gshard"
    #: int8 KV cache with per-(token, head) scales — halves decode's
    #: HBM-bound KV reads (§Perf hillclimb for decode shapes)
    kv_quant: bool = False
    #: attention evaluation: "dense" materializes (S, T) scores (baseline);
    #: "chunked" streams KV in blocks with online softmax (flash-style —
    #: O(S·chunk) live memory; §Perf hillclimb for prefill/train shapes)
    attn_impl: str = "dense"
    attn_chunk: int = 1024
    max_seq_len: int = 32768

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + len(self.pattern) * self.n_periods

    @property
    def layers(self) -> list[LayerSpec]:
        return list(self.prefix) + list(self.pattern) * self.n_periods

    def activation_dtype(self):
        return getattr(torch, self.dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # parameter counting (used for roofline MODEL_FLOPS = 6·N·D) ---------
    def param_count(self, active_only: bool = False) -> int:
        E, H, G, D = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        n = self.vocab_size * E  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * E
        for spec in self.layers:
            n += 2 * E  # norms
            if spec.mixer == "attn":
                n += E * H * D + 2 * E * G * D + H * D * E
            else:
                ssm = self.ssm or SSMConfig()
                d_in = ssm.expand * E
                heads = d_in // ssm.headdim
                proj = 2 * d_in + 2 * ssm.n_groups * ssm.d_state + heads
                n += E * proj + d_in * E            # in/out proj
                n += (d_in + 2 * ssm.n_groups * ssm.d_state) * ssm.conv_kernel
                n += 3 * heads + d_in               # A, D, dt_bias, norm
            if spec.ff == "dense":
                mult = 3 if self.mlp_act == "swiglu" else 2
                n += mult * E * self.d_ff
            elif spec.ff == "moe":
                moe = self.moe
                mult = 3 if self.mlp_act == "swiglu" else 2
                per_expert = mult * E * moe.d_expert
                n += E * moe.n_experts  # router
                if active_only:
                    n += moe.top_k * per_expert
                else:
                    n += moe.n_experts * per_expert
                if moe.n_shared:
                    n += moe.n_shared * mult * E * (moe.d_shared or moe.d_expert)
        return n
