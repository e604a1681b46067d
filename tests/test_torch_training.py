"""The port's training path (``repro_torch.training``, ``distributed.compress``,
``launch.train``) and the kernel backend's gradients: the counterparts of
``tests/test_training.py``, and the port held against the JAX package.

- Optimizer, schedules, clipping, data, checkpoints and the trainer: the
  JAX package's unit tests, on the port.
- Schedules and ``adamw_update`` equal the JAX package's within 1e-6;
  ``SyntheticLM`` batches are bit-identical; the int8 quant-dequant is
  within 1 ulp of JAX's.
- 3 ``Trainer`` steps of both packages on the same weights and data:
  losses and parameters within 1e-4.  One train step of the JAX package's
  ``pallas`` backend with ``contract_strategy="native"`` (interpret mode)
  against the port's ``kernel`` backend: loss and every gradient within
  1e-4.  A checkpoint the JAX ``Trainer`` writes restores into the port's
  ``Trainer``, which resumes with the JAX run's losses within 1e-4.
- The kernel backend's gradients: the role-based core raises under
  autograd, as the JAX package's ``pallas`` backend does, and the native
  path gives the torch backend's gradients even when the kernel's output
  carries no ``grad_fn`` (as the CUDA launch's does not).

Sizes: minicpm-2b smoke at one period, sequences of 16 tokens."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.contract import contract as jcontract
from repro.distributed.compress import Int8Compressor as JInt8Compressor
from repro.distributed.compress import compress_bf16 as jcompress_bf16
from repro.models import transformer as jtransformer
from repro.training import optimizer as jopt
from repro.training.data import SyntheticLM as JSyntheticLM
from repro.training.data import TokenFile as JTokenFile
from repro.training.trainer import TrainConfig as JTrainConfig
from repro.training.trainer import Trainer as JTrainer
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core.contract import contract
from repro_torch.distributed.compress import Int8Compressor, compress_bf16
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model, lm_loss
from repro_torch.models.tree import (
    tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten,
)
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.training.data import SyntheticLM, TokenFile, make_batch_specs
from repro_torch.training.optimizer import (
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
    cosine_schedule, make_schedule, wsd_schedule,
)
from repro_torch.training.trainer import TrainConfig, Trainer, make_train_step

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the JAX test's tolerance for a restart and for a cross-package step
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    jax.clear_caches()


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------ the JAX package's tests
def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, schedule="constant")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float(torch.max(torch.abs(params["w"]))) < 1e-2


def test_grad_clip():
    grads = {"a": torch.full((4,), 100.0)}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-4)


def test_wsd_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      stable_frac=0.8, schedule="wsd")
    f = wsd_schedule(cfg)
    assert float(f(0)) == 0.0
    assert float(f(10)) == pytest.approx(1.0)
    assert float(f(50)) == pytest.approx(1.0)        # stable plateau
    assert float(f(99)) < 0.5                         # decay tail
    g = cosine_schedule(AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100))
    assert float(g(55)) > float(g(90))


def test_synthetic_data_deterministic_and_restorable():
    d1 = SyntheticLM(vocab_size=100, seq_len=16, global_batch=4, seed=7)
    b1 = [next(d1) for _ in range(3)]
    d2 = SyntheticLM(vocab_size=100, seq_len=16, global_batch=4, seed=7)
    next(d2)
    d2.restore({"seed": 7, "step": 1})
    b2 = next(d2)
    np.testing.assert_array_equal(b1[1]["tokens"], b2["tokens"])


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "s": torch.zeros((), dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 5, tree, extra={"foo": 1})
    save_checkpoint(str(tmp_path), 10, tree, extra={"foo": 2})
    assert latest_step(str(tmp_path)) == 10
    like = tree_map(torch.zeros_like, tree)
    restored, extra, step = restore_checkpoint(str(tmp_path), None, like)
    assert step == 10 and extra["foo"] == 2
    assert torch.equal(restored["w"], tree["w"]) and restored["s"].dtype == torch.int32
    # stale tmp dirs never corrupt restores
    os.makedirs(tmp_path / "step_0000000099.tmp")
    assert latest_step(str(tmp_path)) == 10


def test_checkpoint_retention(tmp_path):
    tree = {"w": torch.zeros(3)}
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    kept = sorted(p for p in os.listdir(tmp_path) if p.startswith("step_"))
    assert len(kept) == 2 and kept[-1].endswith("0000000005")


def _tiny_trainer(tmp_path, **tkw):
    cfg = get_config("minicpm-2b", smoke=True).with_(n_periods=1)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=3)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50, schedule="cosine"),
        ckpt_dir=str(tmp_path), ckpt_every=5, **tkw,
    )
    return cfg, Trainer(cfg, tcfg, params, data)


def test_trainer_loss_decreases(tmp_path):
    _, tr = _tiny_trainer(tmp_path)
    hist = tr.run(30)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)


def test_trainer_checkpoint_restart_resumes_identically(tmp_path):
    _, tr = _tiny_trainer(tmp_path)
    tr.run(10)
    tr.save(force=True)
    more = tr.run(3)

    # simulate failure: rebuild from scratch and restore
    _, tr2 = _tiny_trainer(tmp_path)
    tr2.restore()
    assert tr2.step == 10
    assert tr2.data.step == tr.data.step - 3  # cursor restored to step 10
    resumed = tr2.run(3)
    np.testing.assert_allclose(
        [h["loss"] for h in resumed], [h["loss"] for h in more], rtol=TOL
    )


def test_trainer_microbatch_accumulation_matches_full_batch(tmp_path):
    cfg = get_config("minicpm-2b", smoke=True).with_(n_periods=1)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8, seed=3)
    batch = {k: torch.as_tensor(v) for k, v in next(data).items()}

    opt = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10, schedule="constant")
    s_full = make_train_step(cfg, TrainConfig(opt=opt, microbatches=1))
    s_micro = make_train_step(cfg, TrainConfig(opt=opt, microbatches=4))
    st = adamw_init(params)
    p1, *_ = s_full(params, st, batch, None)
    p2, *_ = s_micro(params, st, batch, None)
    # same data, same step: accumulated grads ≈ full-batch grads
    d = max(float(torch.max(torch.abs(a.float() - b.float())))
            for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert d < 5e-3, d


def test_trainer_int8_compression_still_learns(tmp_path):
    _, tr = _tiny_trainer(tmp_path, compression="int8")
    hist = tr.run(30)
    assert np.mean([h["loss"] for h in hist[-5:]]) < np.mean(
        [h["loss"] for h in hist[:5]]
    )
    assert tr.residual is not None and any(float(r.abs().max()) > 0
                                           for r in tree_leaves(tr.residual))


def test_straggler_detection(tmp_path):
    _, tr = _tiny_trainer(tmp_path)
    tr.tcfg.step_deadline_s = 0.0  # every step is a "straggler"
    tr.run(3)
    assert tr.straggler_steps == 3


# ----------------------------------------------- against the JAX package
@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
def test_schedules_and_adamw_update_equal_the_jax_packages(schedule):
    """Every schedule at every step of a run, and three AdamW updates with
    clipping (norm above the limit), within 1e-6."""
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=20, schedule=schedule, grad_clip=0.5)
    tf, jf = make_schedule(AdamWConfig(**kw)), jopt.make_schedule(jopt.AdamWConfig(**kw))
    for step in range(22):
        assert abs(float(tf(step)) - float(jf(jnp.int32(step)))) <= 1e-6 * kw["lr"], step
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32)]}
    tp, jp = tree_map(torch.from_numpy, tree), jax.tree.map(jnp.asarray, tree)
    ts, js = adamw_init(tp), jopt.adamw_init(jp)
    for i in range(3):
        g = {"a": rng.standard_normal((5, 3)).astype(np.float32),
             "b": [rng.standard_normal(7).astype(np.float32)]}
        tp, ts, tm = adamw_update(AdamWConfig(**kw), tp, tree_map(torch.from_numpy, g), ts)
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**kw), jp, jax.tree.map(jnp.asarray, g),
                                       js)
        for (path, t), j in zip(tree_leaves_with_path({"p": tp, "s": ts}),
                                jax.tree.leaves({"p": jp, "s": js})):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=1e-6,
                                       err_msg=f"{path} after update {i + 1}")
        for k in ("lr", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * max(1.0, abs(float(jm[k])))


@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=16, global_batch=4, seed=7),
    dict(vocab_size=122753, seq_len=64, global_batch=2, seed=0, labels=True,
         with_features=(8, 5)),
])
def test_synthetic_batches_are_bit_identical_to_the_jax_packages(kw):
    t, j = SyntheticLM(**kw), JSyntheticLM(**kw)
    for _ in range(3):
        tb, jb = next(t), next(j)
        assert tb.keys() == jb.keys()
        for k in tb:
            assert tb[k].dtype == jb[k].dtype and np.array_equal(tb[k], jb[k]), k
    assert t.state() == j.state()


def test_token_file_and_batch_specs(tmp_path):
    path = str(tmp_path / "toks.npy")
    np.save(path, np.arange(4000, dtype=np.uint16))
    t, j = (cls(path, seq_len=32, global_batch=4, host_id=1, n_hosts=2)
            for cls in (TokenFile, JTokenFile))
    for _ in range(3):
        assert np.array_equal(next(t)["tokens"], next(j)["tokens"])
    t.restore({"step": 1, "path": path})
    j.restore({"step": 1, "path": path})
    assert np.array_equal(next(t)["tokens"], next(j)["tokens"])
    specs = make_batch_specs(get_config("internvl2-2b", smoke=True),
                             ShapeSpec("c", 32, 2, "train"))
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in specs.items()} == {
        "tokens": ((2, 32), torch.int32, "meta"),
        "features": ((2, get_config("internvl2-2b", smoke=True).frontend.n_positions,
                      get_config("internvl2-2b", smoke=True).frontend.feature_dim),
                     torch.float32, "meta"),
        "labels": ((2, 32), torch.int32, "meta")}


def test_compressors_equal_the_jax_packages():
    """int8 quant-dequant (with error feedback) within 1 ulp of JAX's over
    a ragged last block; bf16 rounding bit-identical."""
    rng = np.random.default_rng(1)
    grads = {"w": (rng.standard_normal((37, 29)) * 3).astype(np.float32),
             "v": [rng.standard_normal(300).astype(np.float32)]}
    res = jax.tree.map(lambda g: (rng.standard_normal(g.shape) * 1e-3).astype(np.float32), grads)
    tdeq, tres = Int8Compressor(block=64).compress(tree_map(torch.from_numpy, grads),
                                                  tree_map(torch.from_numpy, res))
    jdeq, jres = JInt8Compressor(block=64).compress(jax.tree.map(jnp.asarray, grads),
                                                   jax.tree.map(jnp.asarray, res))
    for t, j in zip(tree_leaves(tdeq) + tree_leaves(tres),
                    jax.tree.leaves(jdeq) + jax.tree.leaves(jres)):
        t, j = _np(t), np.asarray(j)
        ulp = np.spacing(np.maximum(np.abs(t), np.abs(j)).astype(np.float32))
        assert np.all(np.abs(t - j) <= ulp)
    for t, j in zip(tree_leaves(compress_bf16(tree_map(torch.from_numpy, grads))),
                    jax.tree.leaves(jcompress_bf16(jax.tree.map(jnp.asarray, grads)))):
        assert np.array_equal(_np(t), np.asarray(j))


def _carried(**kw):
    """minicpm-2b smoke at one period in both packages, the JAX package's
    weights carried over."""
    jkw = {**kw, "contract_backend": "pallas"} if kw.get("contract_backend") == "kernel" else kw
    jcfg = jget_config("minicpm-2b", smoke=True).with_(n_periods=1, **jkw)
    cfg = get_config("minicpm-2b", smoke=True).with_(n_periods=1, **kw)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _opt():
    return dict(opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50, schedule="wsd"))


def test_trainer_steps_equal_the_jax_trainers(tmp_path):
    """3 steps of each package's ``Trainer`` (the JAX package on ``xla``,
    the port on ``torch``) from the same weights and data: losses and
    parameters within 1e-4."""
    jcfg, cfg, jp, tp = _carried()
    data = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=3)
    jtr = JTrainer(jcfg, JTrainConfig(opt=jopt.AdamWConfig(**vars(_opt()["opt"]))),
                   jp, JSyntheticLM(**data))
    tr = Trainer(cfg, TrainConfig(**_opt()), tp, SyntheticLM(**data))
    jh, th = jtr.run(3), tr.run(3)
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=TOL)
    for (path, t), j in zip(tree_leaves_with_path(tr.params), jax.tree.leaves(jtr.params)):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=TOL, err_msg=str(path))


def test_kernel_backend_train_step_equals_the_jax_pallas_step():
    """One step's loss and every gradient: the JAX package's ``pallas``
    backend with ``contract_strategy="native"`` (its kernel in interpret
    mode, differentiated through its custom VJP) against the port's
    ``kernel`` backend with the same strategy (the plain version on the
    CPU, differentiated through ``_NativeContraction``), within 1e-4."""
    jcfg, cfg, jp, tp = _carried(contract_backend="kernel", contract_strategy="native")
    batch = next(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=5))
    jloss, jg = jax.value_and_grad(lambda p: jtransformer.lm_loss(jcfg, p, batch)[0])(jp)
    live = [p.clone().requires_grad_() for p in tree_leaves(tp)]
    loss, _ = lm_loss(cfg, tree_unflatten(tp, live), {k: torch.as_tensor(v)
                                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL * abs(float(jloss))
    for (path, _), g, j in zip(tree_leaves_with_path(tp), grads, jax.tree.leaves(jg)):
        scale = max(1.0, float(np.abs(np.asarray(j)).max()))
        assert float(np.abs(_np(g) - np.asarray(j)).max()) <= TOL * scale, path


def test_checkpoint_from_the_jax_trainer_resumes_in_the_port(tmp_path):
    """The JAX ``Trainer`` trains 3 steps and checkpoints; the port's
    ``Trainer`` restores that checkpoint (leaves in ``jax.tree.flatten``
    order, data cursor and step included) and its next 3 steps give the
    JAX run's losses within 1e-4."""
    jcfg, cfg, jp, tp = _carried()
    data = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=3)
    jopt_cfg = jopt.AdamWConfig(**vars(_opt()["opt"]))
    jtr = JTrainer(jcfg, JTrainConfig(opt=jopt_cfg, ckpt_dir=str(tmp_path)), jp,
                   JSyntheticLM(**data))
    jtr.run(3)
    jtr.save(force=True)
    want = jtr.run(3)
    tr = Trainer(cfg, TrainConfig(**_opt(), ckpt_dir=str(tmp_path)),
                 tree_map(torch.zeros_like, tp), SyntheticLM(**data))
    assert tr.restore() == 3 and tr.step == 3 and tr.data.step == 3
    assert int(tr.opt_state["step"]) == 3 and tr.opt_state["step"].dtype == torch.int32
    got = tr.run(3)
    np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in want], rtol=TOL)


def test_checkpoint_and_trainer_take_sharding(tmp_path):
    """On a gloo world of one: ``restore_checkpoint(shardings=)`` places
    each leaf on its sharding, and ``Trainer(rules=)`` trains placed
    DTensors to the unsharded trainer's losses (every block is the whole
    tensor); with int8 compression too, its residual a DTensor per leaf
    placed as the parameters, equal to the unsharded trainer's, and a
    sharded checkpoint restores it bit-equal, placed the same."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import NamedSharding, P, ShardingRules
    from repro_torch.launch.mesh import make_host_mesh

    w = torch.arange(8.0).reshape(2, 4)
    save_checkpoint(str(tmp_path / "w"), 1, {"w": w})
    cfg = get_config("minicpm-2b", smoke=True).with_(n_periods=1)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    data = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=0)
    want = [h["loss"] for h in Trainer(cfg, TrainConfig(**_opt()), params,
                                       SyntheticLM(**data)).run(2)]
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        got, _, step = restore_checkpoint(str(tmp_path / "w"), None, {"w": torch.zeros(2, 4)},
                                          shardings={"w": NamedSharding(mesh, P(None, "model"))})
        assert step == 1 and isinstance(got["w"], DTensor)
        assert got["w"].placements[1].is_shard(1) and torch.equal(got["w"].full_tensor(), w)
        tr = Trainer(cfg, TrainConfig(**_opt()), params, SyntheticLM(**data),
                     rules=ShardingRules(mesh))
        assert all(isinstance(p, DTensor) for p in tree_leaves(tr.params))
        assert [h["loss"] for h in tr.run(2)] == want
        int8 = TrainConfig(**_opt(), compression="int8", ckpt_dir=str(tmp_path / "c"))
        plain = Trainer(cfg, int8, params, SyntheticLM(**data))
        want8 = [h["loss"] for h in plain.run(2)]
        tr = Trainer(cfg, int8, params, SyntheticLM(**data), rules=ShardingRules(mesh))
        assert [h["loss"] for h in tr.run(2)] == want8
        for r, p, q in zip(tree_leaves(tr.residual), tree_leaves(tr.params),
                           tree_leaves(plain.residual)):
            assert isinstance(r, DTensor) and r.placements == p.placements
            assert torch.equal(r.full_tensor(), q)
        tr.save(force=True)
        back = Trainer(cfg, int8, params, SyntheticLM(**data), rules=ShardingRules(mesh))
        assert back.restore() == 2
        for r, b in zip(tree_leaves(tr.residual), tree_leaves(back.residual)):
            assert isinstance(b, DTensor) and b.placements == r.placements
            assert torch.equal(b.full_tensor(), r.full_tensor())
    finally:
        dist.destroy_process_group()


# ------------------------------------------- kernel-backend gradients
def test_role_based_kernel_core_raises_under_autograd():
    """``contract(..., strategy="auto" | "batched", backend="kernel")`` with
    an operand that needs a gradient raises, as the JAX package's
    ``backend="pallas"`` does; the same products under ``strategy="native"``
    differentiate, and without autograd the role-based core runs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    k = rng.standard_normal((4, 6)).astype(np.float32)
    p = rng.standard_normal((3, 4, 5)).astype(np.float32)
    for spec, a, b, strategy in (("bse,ef->bsf", x, w, "auto"),
                                 ("km,pkn->pnm", k, p, "batched")):
        with pytest.raises(Exception):
            jax.grad(lambda bb: jnp.sum(jcontract(spec, jnp.asarray(a), bb,
                                                  strategy=strategy, backend="pallas")))(
                jnp.asarray(b))
        A, B = torch.from_numpy(a), torch.from_numpy(b).requires_grad_()
        with pytest.raises(NotImplementedError, match="strategy='native'"):
            contract(spec, A, B, strategy=strategy, backend="kernel")
        contract(spec, A, B, strategy="native", backend="kernel").sum().backward()
        Bw = torch.from_numpy(b).requires_grad_()
        torch.einsum(spec, A, Bw).sum().backward()
        torch.testing.assert_close(B.grad, Bw.grad, rtol=1e-5, atol=1e-5)
        with torch.no_grad():
            torch.testing.assert_close(contract(spec, A, B, strategy=strategy, backend="kernel"),
                                       torch.einsum(spec, A, B), rtol=1e-5, atol=1e-5)


def test_native_gradients_survive_a_detached_kernel_output(monkeypatch):
    """A stand-in for the card: ``native_gemm`` returns a result with no
    ``grad_fn``, as the CUDA launch's fresh tensor has none.  ``lm_loss``
    on ``kernel`` + ``native`` must still give every leaf the torch
    backend's gradient, within 1e-4."""
    real = ops.native_gemm
    calls = []

    def detached(A, B, **kw):
        calls.append(kw["c_modes"])
        return real(A, B, **kw).detach()

    monkeypatch.setattr(ops, "native_gemm", detached)
    cfg = get_config("minicpm-2b", smoke=True).with_(n_periods=1)
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in next(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=1)).items()}
    grads = {}
    for backend, strategy in (("torch", "auto"), ("kernel", "native")):
        live = [p.clone().requires_grad_() for p in tree_leaves(params)]
        loss, _ = lm_loss(cfg.with_(contract_backend=backend, contract_strategy=strategy),
                          tree_unflatten(params, live), batch)
        grads[backend] = (loss.detach(), torch.autograd.grad(loss, live))
    # 9 contractions a layer and the LM head; remat recomputes the layer's
    # 9; each product's backward is two native contractions
    assert len(calls) == (9 + 1) + 9 + 2 * (9 + 1)
    torch.testing.assert_close(grads["kernel"][0], grads["torch"][0], rtol=TOL, atol=TOL)
    for (path, _), g, w in zip(tree_leaves_with_path(params), grads["kernel"][1],
                               grads["torch"][1]):
        assert float(w.abs().max()) > 0, path
        assert float((g - w).abs().max()) <= TOL * max(1.0, float(w.abs().max())), path


# ------------------------------------------------------------------- CLI
def test_train_cli_on_the_cpu(tmp_path):
    """The launcher trains on the CPU, checkpoints and resumes; ``--mesh
    1x1`` trains sharded in one process, and a mesh of more ranks without
    ``torch.distributed.run`` exits naming it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "minicpm-2b",
            "--smoke", "--device", "cpu", "--seq-len", "16", "--batch", "2"]

    def run(*extra):
        return subprocess.run(base + list(extra), env=env, capture_output=True, text=True,
                              timeout=300, stdin=subprocess.DEVNULL)

    first = run("--steps", "10", "--ckpt-dir", str(tmp_path))
    assert first.returncode == 0, first.stderr
    assert "step 10: loss=" in first.stdout and "final checkpoint at step 10" in first.stdout
    again = run("--steps", "10", "--ckpt-dir", str(tmp_path), "--resume")
    assert again.returncode == 0, again.stderr
    assert "resumed from step 10" in again.stdout
    assert "step 20: loss=" in again.stdout
    mesh = run("--steps", "2", "--mesh", "1x1")
    assert mesh.returncode == 0, mesh.stderr
    assert "mesh: 1x1 over 1 cpu ranks" in mesh.stdout and "step 2: loss=" in mesh.stdout
    alone = run("--steps", "1", "--mesh", "2x4")
    assert alone.returncode != 0 and "torch.distributed.run" in alone.stderr


# ------------------------------------------------------------------ card
@pytest.mark.gpu
def test_kernel_train_step_on_the_card():
    """On the card, ``lm_loss`` and its gradients on ``kernel`` + ``native``
    (float32 smoke widths) equal the CPU's plain version within 1e-4 of
    each leaf's largest magnitude, with every contraction of the forward,
    the remat recompute and the backward a ``native_gemm`` launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.training.trainer import value_and_grad

    cfg = get_config("minicpm-2b", smoke=True, n_periods=1, contract_backend="kernel",
                     contract_strategy="native")
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    batch = next(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=1))
    out = {}
    for dev in ("cpu", "cuda"):
        before = native_gemm.launches
        out[dev] = value_and_grad(cfg, tree_map(lambda t: t.to(dev), params),
                                  {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        launched = native_gemm.launches - before
    assert launched == (9 + 1) + 9 + 2 * (9 + 1)
    assert abs(float(out["cuda"][0]) - float(out["cpu"][0])) <= TOL
    for (path, g), w in zip(tree_leaves_with_path(out["cuda"][2]), tree_leaves(out["cpu"][2])):
        scale = max(1.0, float(w.abs().max()))
        assert float((g.cpu() - w).abs().max()) <= TOL * scale, path


@pytest.mark.gpu
def test_mamba2_kernel_train_step_on_the_card():
    """On the card, a mamba2 smoke train step (2 periods, 2 x 64 tokens in
    chunks of 16, float32) on ``kernel`` + ``native``: the loss and every
    gradient within 1e-4 of each leaf's largest magnitude of the torch
    backend's float32 step on the card (TF32 off), the ``norm2`` leaf of the
    feed-forward-free layers zero in both; 24 ``native_gemm`` launches a
    layer (six products: forward, remat's recompute, dX, dW) and 3 for the
    tied head."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.sb_gemm import native_gemm
    from repro_torch.training.trainer import value_and_grad

    cfg = get_config("mamba2-1.3b", smoke=True, n_periods=2, contract_backend="kernel",
                     contract_strategy="native")
    params = tree_map(lambda t: t.cuda(), Model(cfg).init(torch.Generator().manual_seed(0)))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(SyntheticLM(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=2, seed=1)).items()}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = native_gemm.launches
        got = value_and_grad(cfg, params, batch)
        launched = native_gemm.launches - before
        want = value_and_grad(cfg.with_(contract_backend="torch", contract_strategy="auto"),
                              params, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert launched == 24 * cfg.n_periods + 3
    assert abs(float(got[0]) - float(want[0])) <= TOL * abs(float(want[0]))
    for (path, g), w in zip(tree_leaves_with_path(got[2]), tree_leaves(want[2])):
        assert bool(torch.isfinite(g).all()), path
        if path == ("pattern", 0, "norm2"):
            assert not bool(g.any()) and not bool(w.any()), path
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= TOL * scale, path
