"""The loss under sharding rules at published widths, traced, and the JAX
package's own loss on vocab-sharded logits.

The port: minicpm-2b ``train_4k`` at 4 layers (the cut of ``chip_smoke.py``
phase 17) traced by ``launch.dryrun.dryrun_cell`` on fake CPU tensors in a
fake world of 256 ranks (16x16) and of 512 (2x16x16), on the library
backend and, on 16x16, the kernel backend.  No storage that rank 0 makes
in the step, forward or backward, has the vocab (122880) as its last dim:
``models.layers.token_nll`` works on each rank's (B/16, 4095, 7680) block.
The traced peak per rank falls from 612.67 GB (16x16) and 805.66 GB
(2x16x16), when the loss gathered the vocab and built its gradient at the
global (B, S-1, V) shape, to under 130 GB and 65 GB; the flops, which
count only products, stay what they were.

The JAX package (in a subprocess with 8 simulated host devices): the
gradient of its loss arithmetic (``log_softmax`` and ``take_along_axis``,
as ``repro.models.transformer.lm_loss`` has them) on (8, 256, 4096) f32
logits sharded ``P("data", None, "model")`` on a 2x4 mesh compiles with no
all-gather, and with temp memory of at most twice the local block: GSPMD
keeps the loss vocab-sharded, as the port now does.
"""

import inspect
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.utils import CostCounter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = get_config("minicpm-2b").vocab_size
OVERRIDES = {"n_periods": 4}
KERNEL = {"contract_backend": "kernel", "contract_strategy": "native"}
#: the 16x16 library cell's flops before and after the vocab-parallel loss
FLOPS_16X16 = 54_106_924_253_184
#: name -> (multi_pod, extra overrides, peak bound in bytes, flops)
CELLS = {
    "16x16": (False, {}, 130e9, FLOPS_16X16),
    "2x16x16": (True, {}, 65e9, FLOPS_16X16 // 2),     # the same batch over twice the ranks
    "16x16_kernel": (False, KERNEL, 130e9, 54_541_789_691_904),
}

JAX_CODE = """
import json
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

B, S, V = 8, 256, 4096
mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))

def loss(logits, targets):
    # repro.models.transformer.lm_loss's arithmetic
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll)

xs, ts = NamedSharding(mesh, P("data", None, "model")), NamedSharding(mesh, P("data", None))
compiled = jax.jit(jax.grad(loss), in_shardings=(xs, ts), out_shardings=xs).lower(
    jax.ShapeDtypeStruct((B, S, V), jnp.float32, sharding=xs),
    jax.ShapeDtypeStruct((B, S), jnp.int32, sharding=ts)).compile()
hlo = compiled.as_text()
print(json.dumps({"all_gather": hlo.count(" all-gather(") + hlo.count(" all-gather-start("),
                  "all_reduce": hlo.count(" all-reduce(") + hlo.count(" all-reduce-start("),
                  "temp": compiled.memory_analysis().temp_size_in_bytes,
                  "local": B * S * V * 4 // 8, "global": B * S * V * 4}))
"""


@pytest.fixture(scope="module")
def jax_proc():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_CODE)], text=True,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            stdin=subprocess.DEVNULL)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_jax_reference_keeps_the_loss_gradient_vocab_sharded(jax_proc):
    src = inspect.getsource(jtransformer.lm_loss)
    assert "jax.nn.log_softmax(logits_t, axis=-1)" in src
    assert "jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]" in src
    out, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, err
    r = json.loads(out.strip().splitlines()[-1])
    assert r["all_gather"] == 0, r
    assert r["all_reduce"] > 0, r                    # the max and the sums cross ranks
    assert r["temp"] <= 2 * r["local"] < r["global"], r


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_train_cell_builds_nothing_of_the_vocabs_width(cell, monkeypatch):
    multi_pod, extra, peak, flops = CELLS[cell]
    wide = []
    track = CostCounter._track

    def spy(self, t, op):
        if t.ndim and t.shape[-1] == VOCAB:
            wide.append((op, tuple(t.shape)))
        return track(self, t, op)

    monkeypatch.setattr(CostCounter, "_track", spy)
    rec = dryrun.dryrun_cell("minicpm-2b", "train_4k", multi_pod=multi_pod,
                             cfg_overrides={**OVERRIDES, **extra}, device="cpu", verbose=False)
    assert rec["status"] == "ok"
    assert wide == []
    assert all(e["shape"][-1] != VOCAB for e in rec["peak_live"]), rec["peak_live"]
    assert rec["peak_bytes_per_device"] < peak, rec["peak_bytes_per_device"]
    assert rec["flops"] == flops
    # the loss's three all-reduces over the vocab's ranks: (B/ranks, S-1) f32
    assert rec["collective_counts"]["all-reduce"] >= 3
