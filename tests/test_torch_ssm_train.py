"""Training a state-space model with the port: mamba2 and jamba gradients
held against the JAX package, and the launches of one kernel-backend step
of mamba2-1.3b at its published width.

- One step's loss and every gradient, remat on, against
  ``jax.value_and_grad(repro.models.transformer.lm_loss)`` from the same
  weights and batch, within 1e-4 of each leaf's largest magnitude (at
  least 1): mamba2 smoke at 2 periods and jamba smoke at 1 period, each on
  the port's ``torch`` backend against the JAX package's ``xla``, and on
  ``kernel`` with ``contract_strategy="native"`` (the plain version on the
  CPU, differentiated through ``_NativeContraction``) against ``pallas``
  with the same strategy (interpret mode, its custom VJP).
- A mamba2 layer has no feed-forward (``ff="none"``), so its ``norm2``
  leaf gets an identically zero gradient in both packages, the one leaf
  ``chip_smoke.unreached_leaves`` derives from the config.
- Where ``dt`` is large the SSD's upper-triangle ``exp`` overflows: the
  JAX package's gradient goes NaN there, the port's stays finite.
- 3 ``Trainer`` steps of both packages on mamba2 smoke: losses and
  parameters within 1e-4; a checkpoint restart of the port's ``Trainer``
  repeats the losses.
- One kernel-backend train step of mamba2-1.3b at published width (one
  layer, 2 x 256 tokens), traced on fake tensors under
  ``utils.CostCounter``: ``native_gemm``'s launches by route are what
  ``chip_smoke.ssm_train_launches_per_step`` derives from the model.

Sizes: smoke widths (d_model 64, d_state 16, head dim 8, chunk 16),
2 sequences of 64 tokens, so the SSD runs 4 chunks and carries a state
across them."""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro.training import optimizer as jopt
from repro.training.data import SyntheticLM as JSyntheticLM
from repro.training.trainer import TrainConfig as JTrainConfig
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models.tree import tree_leaves, tree_leaves_with_path
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, Trainer, value_and_grad

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the JAX test's tolerance for a cross-package step and a restart
TOL = 1e-4
#: arch id and smoke periods of each case
ARCHS = {"mamba2": ("mamba2-1.3b", 2), "jamba": ("jamba-v0.1-52b", 1)}
#: the port's backend options and the JAX package's counterpart
BACKENDS = {
    "torch": ({}, {}),
    "kernel": ({"contract_backend": "kernel", "contract_strategy": "native"},
               {"contract_backend": "pallas", "contract_strategy": "native"}),
}
SEQ, BATCH = 64, 2


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()


def _np(x):
    return np.asarray(x.detach().cpu())


def _carried(arch: str, backend: str = "torch"):
    """Smoke ``arch`` in both packages, the JAX package's weights carried
    over to the port."""
    arch_id, periods = ARCHS[arch]
    kw, jkw = BACKENDS[backend]
    jcfg = jget_config(arch_id, smoke=True).with_(n_periods=periods, **jkw)
    cfg = get_config(arch_id, smoke=True).with_(n_periods=periods, **kw)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, seed: int = 5):
    return next(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                            seed=seed))


_STEPS: dict = {}


def _one_step(arch: str, backend: str):
    """Each package's loss and gradients on the same weights and batch,
    remat on (computed once per case)."""
    if (arch, backend) not in _STEPS:
        jcfg, cfg, jp, tp = _carried(arch, backend)
        batch = _batch(cfg)
        jloss, jg = jax.value_and_grad(
            lambda p: jtransformer.lm_loss(jcfg, p, batch, remat=True)[0])(jp)
        loss, _, grads = value_and_grad(cfg, tp, {k: torch.as_tensor(v)
                                                  for k, v in batch.items()}, remat=True)
        _STEPS[arch, backend] = (cfg, float(jloss), [np.asarray(j) for j in jax.tree.leaves(jg)],
                                 float(loss), tree_leaves_with_path(grads))
    return _STEPS[arch, backend]


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_gradients_equal_the_jax_packages(arch, backend):
    """One step's loss and every gradient within 1e-4 of the JAX package's
    (max abs over max(1, the JAX leaf's largest magnitude)); every leaf
    finite."""
    _, jloss, jgrads, loss, grads = _one_step(arch, backend)
    assert abs(loss - jloss) <= TOL * max(1.0, abs(jloss)), (loss, jloss)
    assert len(grads) == len(jgrads)
    for (path, g), j in zip(grads, jgrads):
        g = _np(g)
        assert g.shape == j.shape and np.isfinite(g).all(), path
        scale = max(1.0, float(np.abs(j).max()))
        assert float(np.abs(g - j).max()) <= TOL * scale, path


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_norm2_of_a_layer_without_feed_forward_gets_no_gradient(backend):
    """mamba2's layers have ``ff="none"``: the ``norm2`` leaf's gradient is
    identically zero in both packages, and it is the only such leaf."""
    cfg, _, jgrads, _, grads = _one_step("mamba2", backend)
    zero_port = {path for path, g in grads if not bool(g.abs().max() > 0)}
    zero_jax = {path for (path, _), j in zip(grads, jgrads) if not np.abs(j).max() > 0}
    derived = _chip_smoke().unreached_leaves(cfg)
    assert zero_port == zero_jax == derived == {("pattern", 0, "norm2")}


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_a_large_dt_leaves_the_ports_gradient_finite(backend):
    """With every ``dt`` near 4 (``dt_bias`` raised by 4) the SSD's
    upper-triangle ``exp(s_i - s_j)`` overflows: the JAX package keeps a
    finite loss, but its ``where(mask, exp(diff), 0)`` gives a gradient of
    0·inf = NaN (a fault of the reference the port does not copy).  The
    port masks ``diff`` before the exp: the same loss within 1e-4 and
    every gradient finite, with the zero ``norm2`` leaf as before."""
    jcfg, cfg, jp, _ = _carried("mamba2", backend)
    jp["pattern"][0]["mamba"]["dt_bias"] = jp["pattern"][0]["mamba"]["dt_bias"] + 4.0
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(cfg)
    jloss, jg = jax.value_and_grad(
        lambda p: jtransformer.lm_loss(jcfg, p, batch, remat=True)[0])(jp)
    assert np.isfinite(float(jloss))
    assert not all(np.isfinite(np.asarray(j)).all() for j in jax.tree.leaves(jg))
    loss, _, grads = value_and_grad(cfg, tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    assert {path for path, g in tree_leaves_with_path(grads)
            if not bool(g.abs().max() > 0)} == {("pattern", 0, "norm2")}


def _opt():
    return AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50, schedule="wsd")


def test_trainer_steps_equal_the_jax_trainers():
    """3 steps of each package's ``Trainer`` on mamba2 smoke (the JAX
    package on ``xla``, the port on ``torch``) from the same weights and
    data: losses and parameters within 1e-4."""
    jcfg, cfg, jp, tp = _carried("mamba2")
    data = dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=3)
    jtr = JTrainer(jcfg, JTrainConfig(opt=jopt.AdamWConfig(**vars(_opt()))), jp,
                   JSyntheticLM(**data))
    tr = Trainer(cfg, TrainConfig(opt=_opt()), tp, SyntheticLM(**data))
    jh, th = jtr.run(3), tr.run(3)
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=TOL)
    for (path, t), j in zip(tree_leaves_with_path(tr.params), jax.tree.leaves(jtr.params)):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=TOL, err_msg=str(path))


def test_checkpoint_restart_repeats_the_losses(tmp_path):
    """The port's mamba2 ``Trainer`` on the kernel backend checkpoints at
    step 3; a fresh ``Trainer`` restores it and repeats steps 4-5's
    losses within rtol 1e-4."""
    _, cfg, _, tp = _carried("mamba2", "kernel")
    data = dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=3)
    tcfg = TrainConfig(opt=_opt(), ckpt_dir=str(tmp_path), ckpt_every=10**9)
    tr = Trainer(cfg, tcfg, tp, SyntheticLM(**data))
    tr.run(3)
    tr.save(force=True)
    want = [h["loss"] for h in tr.run(2)]
    again = Trainer(cfg, tcfg, tp, SyntheticLM(**data))
    assert again.restore() == 3 and again.step == 3 and again.data.step == 3
    got = [h["loss"] for h in again.run(2)]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TOL)


# ------------------------------------------ launches at published width
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("periods", [1, 2])
def test_kernel_train_step_launches_by_route_at_published_width(periods):
    """One kernel-backend train step of mamba2-1.3b at published width
    (d_model 2048, 64 heads of 64, d_state 128, vocab 50304), ``periods``
    layers, 2 x 256 tokens, traced on fake tensors: ``native_gemm``'s
    calls by route are 24 a layer and 3 for the tied head (at one layer
    ``wgmma`` 11, ``batched`` 8, ``fbatched`` 4, ``gathered`` 4), as
    ``chip_smoke.ssm_train_launches_per_step`` derives them; at 48 layers
    that function gives 1155."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_params
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.trainer import make_train_step
    from repro_torch.utils import CostCounter

    cs = _chip_smoke()
    cfg = get_config("mamba2-1.3b").with_(n_periods=periods, contract_backend="kernel",
                                          contract_strategy="native")
    step = make_train_step(cfg, TrainConfig(opt=_opt()))
    with FakeTensorMode():
        params = init_params(None, cfg, device="cpu")
        state = adamw_init(params)
        batch = {"tokens": torch.zeros((2, 256), dtype=torch.int32)}
        with CostCounter() as cc:
            step(params, state, batch, None)
    got = cc.costs()
    want = cs.ssm_train_launches_per_step(cfg)
    assert got["routes"] == {"repro_torch.native_gemm": want}
    assert got["ops"] == {"repro_torch.native_gemm": 24 * periods + 3}
    if periods == 1:
        assert want == {"wgmma": 11, "batched": 8, "fbatched": 4, "gathered": 4}
    full = cs.ssm_train_launches_per_step(get_config("mamba2-1.3b"))
    assert full == {"wgmma": 387, "batched": 384, "fbatched": 192, "gathered": 192}
    assert sum(full.values()) == 1155
