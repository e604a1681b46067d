"""Fixed-slot serving engine — a thin wrapper over the runtime.

:class:`ServeEngine` keeps the original step-locked API (``admit`` /
``step`` / ``serve``, pretune + precompile warm-ups) but
delegates everything to :class:`repro_torch.runtime.engine.ServingRuntime`
configured in **legacy mode**: whole-prompt prefill (no chunking) and
full-slot decode (no bucketing).  In that configuration the runtime
runs what the old engine did — every slot decodes every step on the
stacked cache, prefill runs each prompt whole — which makes this class
the token-identical correctness oracle the continuous-batching runtime
is differential-tested against (``tests/test_torch_runtime.py``).

Use :class:`~repro_torch.runtime.engine.ServingRuntime` directly for real
traffic — chunked prefill, bucketed decode and metrics are its defaults.

The port of ``repro.serving.engine``; ``mesh=`` and ``sharding_rules=``
pass through to the runtime, which then serves sharded.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.engine import ServingRuntime
from repro_torch.runtime.scheduler import Request

__all__ = ["Request", "ServeEngine"]


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 1024, greedy: bool = True,
                 pretune: bool = False, tuner=None,
                 tuning_cache=None, tune_policy: str | None = None,
                 pretune_prompt_lens: tuple[int, ...] = (8, 16, 32),
                 precompile: bool = True,
                 mesh=None, sharding_rules=None):
        """See :class:`repro_torch.runtime.engine.ServingRuntime` for the
        parameter semantics (``pretune`` warms the tuning cache —
        ``tune_policy="predict"`` makes that warm-up predict-first,
        ``precompile`` warms the program cache)."""
        self._rt = ServingRuntime(
            cfg, params, slots=slots, max_len=max_len, greedy=greedy,
            chunked_prefill=False, bucketed_decode=False,
            pretune=pretune, tuner=tuner, tuning_cache=tuning_cache,
            tune_policy=tune_policy,
            pretune_prompt_lens=pretune_prompt_lens, precompile=precompile,
            mesh=mesh, sharding_rules=sharding_rules,
        )

    # ---------------------------------------------------- runtime passthrough
    @property
    def cfg(self):
        return self._rt.cfg

    @property
    def params(self):
        return self._rt.params

    @property
    def slots(self) -> int:
        return self._rt.slots

    @property
    def max_len(self) -> int:
        return self._rt.max_len

    @property
    def greedy(self) -> bool:
        return self._rt.greedy

    @property
    def mesh(self):
        return self._rt.mesh

    @property
    def cache(self):
        return self._rt.cache

    @property
    def runtime(self) -> ServingRuntime:
        return self._rt

    @property
    def tuner(self):
        return self._rt.tuner

    @property
    def pretune_stats(self):
        return self._rt.pretune_stats

    @property
    def program_stats(self):
        return self._rt.program_stats

    @property
    def active(self) -> dict:
        """slot -> live :class:`Request` (the old engine's view)."""
        return {
            slot: state.request
            for slot, state in self._rt.scheduler.active.items()
        }

    # ----------------------------------------------------------- autotuning
    def contraction_working_set(
        self, prompt_lens: tuple[int, ...] = (8, 16, 32)
    ) -> list[tuple]:
        return self._rt.contraction_working_set(prompt_lens)

    def precompile_programs(
        self, prompt_lens: tuple[int, ...] = (8, 16, 32)
    ) -> dict:
        return self._rt.precompile_programs(prompt_lens)

    def warmup_tuning(self, **kw) -> dict:
        return self._rt.warmup_tuning(**kw)

    # ------------------------------------------------------------- serving
    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot.  Returns False if full."""
        return self._rt.admit_now(req)

    def step(self) -> None:
        """One step-locked decode across all active slots."""
        if self._rt.scheduler.n_active:
            self._rt.tick()

    def serve(self, requests: list[Request], max_steps: int = 10_000):
        """Run to completion with continuous batching (see
        :meth:`repro_torch.runtime.engine.ServingRuntime.serve` for the
        ``max_steps`` exhaustion semantics)."""
        return self._rt.serve(requests, max_steps=max_steps)
