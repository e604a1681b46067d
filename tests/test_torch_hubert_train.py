"""Training an encoder-only audio model with the port: hubert held against
the JAX package, and the launches of one kernel-backend step of
hubert-xlarge at its published width.

- A narrow hubert with the published ratios and head dim 80 (d_model 160,
  2 heads of 80, d_ff 640 with GELU, the 504-entry codebook head padded to
  512 as ``get_config`` pads every vocab in both packages, 512-d frames, 2
  periods, float32): one step's loss and every gradient, remat
  on, within 1e-4 of ``jax.value_and_grad(repro.models.transformer.
  lm_loss)`` from the same weights and batch, at 13 and 16 frames, with
  and without a loss mask, on the port's ``torch`` backend against the
  JAX package's ``xla`` and on ``kernel`` with ``contract_strategy=
  "native"`` against ``pallas`` with the same strategy (interpret mode).
- Attention is bidirectional: a change to the last frame's features moves
  frame 0's logits, by the same amount in both packages.
- ``embed`` is never read under an audio frontend: its gradient is exactly
  zero in both packages, the one leaf ``chip_smoke.unreached_leaves``
  derives from the config.
- 3 ``Trainer`` steps of both packages on the audio ``SyntheticLM``:
  losses and parameters within 1e-4; a checkpoint restart of the port's
  ``Trainer`` repeats the losses bit for bit.
- One kernel-backend train step of hubert-xlarge at published width (1
  and 2 layers, 4 crops of 781 and of 768 frames), traced on fake tensors
  under ``utils.CostCounter``: ``native_gemm``'s launches by route are what
  ``chip_smoke.hubert_train_launches_per_step`` derives from the model.
- ``chip_smoke.hubert_train_path`` (phase 26) runs through on the CPU at
  the narrow widths in bf16, its card-only calls stubbed, and so does
  ``ssm_train_path`` (phase 23), which shares its training checks."""

import importlib.util
import pathlib

import chip_rehearsal
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.tree import tree_leaves_with_path
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, Trainer, value_and_grad

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the JAX test's tolerance for a cross-package step and a trainer run
TOL = 1e-4
ARCH = "hubert-xlarge"
#: the published ratios at a narrow width: head dim 80, d_ff 4 x d_model
NARROW = dict(d_model=160, n_heads=2, n_kv_heads=2, d_ff=640, n_periods=2)
#: the port's backend options and the JAX package's counterpart
BACKENDS = {
    "torch": ({}, {}),
    "kernel": ({"contract_backend": "kernel", "contract_strategy": "native"},
               {"contract_backend": "pallas", "contract_strategy": "native"}),
}
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches():
    yield
    import jax

    jax.clear_caches()


def _np(x):
    return np.asarray(x.detach().cpu())


def _chip_smoke():
    return chip_rehearsal.chip_smoke()


def _narrow(backend: str = "torch", **kw):
    """The narrow float32 hubert in the port."""
    return get_config(ARCH).with_(**NARROW, dtype="float32", **BACKENDS[backend][0], **kw)


def _carried(backend: str = "torch"):
    """The narrow hubert in both packages, the JAX package's weights carried
    over to the port."""
    import jax

    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtransformer

    jcfg = jget_config(ARCH).with_(**NARROW, dtype="float32", **BACKENDS[backend][1])
    cfg = _narrow(backend)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), "cpu")


def _data(cfg, seq_len: int, seed: int):
    """The audio stream ``launch.train`` builds for a frontend model."""
    fe = cfg.frontend
    return SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=BATCH, seed=seed,
                       with_features=(fe.n_positions or None, fe.feature_dim), labels=True)


def _batch(cfg, seq_len: int, masked: bool):
    batch = next(_data(cfg, seq_len, seed=5))
    if masked:
        rng = np.random.default_rng(7)
        batch["mask"] = (rng.random((BATCH, seq_len)) < 0.6).astype(np.float32)
    return batch


_STEPS: dict = {}


def _one_step(backend: str, seq_len: int, masked: bool):
    """Each package's loss and gradients on the same weights and batch,
    remat on (computed once per case)."""
    import jax

    from repro.models import transformer as jtransformer

    key = backend, seq_len, masked
    if key not in _STEPS:
        jcfg, cfg, jp, tp = _carried(backend)
        batch = _batch(cfg, seq_len, masked)
        jloss, jg = jax.value_and_grad(
            lambda p: jtransformer.lm_loss(jcfg, p, batch, remat=True)[0])(jp)
        loss, _, grads = value_and_grad(cfg, tp, {k: torch.as_tensor(v)
                                                  for k, v in batch.items()}, remat=True)
        _STEPS[key] = (cfg, float(jloss), [np.asarray(j) for j in jax.tree.leaves(jg)],
                       float(loss), tree_leaves_with_path(grads))
    return _STEPS[key]


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("seq_len", [13, 16])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_loss_and_gradients_equal_the_jax_packages(backend, seq_len, masked):
    """One step's loss and every gradient within 1e-4 of the JAX package's
    (max abs over max(1, the JAX leaf's largest magnitude)); every leaf
    finite.  At 13 frames a bf16 probability row would be 26 bytes, at 16
    32: on the card the products reading P take ``gathered`` and
    ``batched``; here both take the plain version through the same
    ``_NativeContraction``."""
    _, jloss, jgrads, loss, grads = _one_step(backend, seq_len, masked)
    assert abs(loss - jloss) <= TOL * max(1.0, abs(jloss)), (loss, jloss)
    assert len(grads) == len(jgrads)
    for (path, g), j in zip(grads, jgrads):
        g = _np(g)
        assert g.shape == j.shape and np.isfinite(g).all(), path
        scale = max(1.0, float(np.abs(j).max()))
        assert float(np.abs(g - j).max()) <= TOL * scale, path


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_embed_of_an_audio_model_gets_no_gradient(backend):
    """The frames are the whole sequence, so ``embed`` is never read: its
    gradient is identically zero in both packages (the port's
    ``value_and_grad`` fills an unreached leaf with zeros), it is the only
    such leaf, and ``chip_smoke.unreached_leaves`` names it; phase 23's
    leaves stay ``norm2`` of the layers without a feed-forward."""
    cs = _chip_smoke()
    for masked in (False, True):
        cfg, _, jgrads, _, grads = _one_step(backend, 13, masked)
        zero_port = {path for path, g in grads if not bool(g.abs().max() > 0)}
        zero_jax = {path for (path, _), j in zip(grads, jgrads) if not np.abs(j).max() > 0}
        assert zero_port == zero_jax == cs.unreached_leaves(cfg) == {("embed",)}
    assert cs.unreached_leaves(get_config("mamba2-1.3b")) == {("pattern", 0, "norm2")}
    assert cs.unreached_leaves(get_config("internvl2-2b")) == set()


def test_attention_is_bidirectional_in_both_packages():
    """A change to the last frame's features moves frame 0's logits (an
    encoder attends both ways); the move is the JAX package's within 1e-4
    of frame 0's largest logit."""
    import jax

    from repro.models import transformer as jtransformer

    jcfg, cfg, jp, tp = _carried()
    batch = _batch(cfg, 16, masked=False)
    moved = dict(batch, features=batch["features"].copy())
    moved["features"][:, -1] += 1.0
    got, want = [], []
    for b in (batch, moved):
        with torch.no_grad():
            got.append(_np(transformer.forward(cfg, tp, {k: torch.as_tensor(v)
                                                         for k, v in b.items()})[0][:, 0]))
        want.append(np.asarray(jtransformer.forward(jcfg, jp, b)[0][:, 0]))
    d_port, d_jax = got[1] - got[0], want[1] - want[0]
    scale = float(np.abs(want[0]).max())
    assert float(np.abs(d_jax).max()) > 1e-3 * scale    # the reference moves too
    assert float(np.abs(d_port).max()) > 1e-3 * scale
    np.testing.assert_allclose(d_port, d_jax, rtol=0, atol=TOL * scale)
    # and a causal mask would not have let it: the same change under
    # causal attention leaves frame 0 where it was
    causal = cfg.with_(encoder_only=False, causal=True)
    with torch.no_grad():
        c = [_np(transformer.forward(causal, tp, {k: torch.as_tensor(v)
                                                  for k, v in b.items()})[0][:, 0])
             for b in (batch, moved)]
    np.testing.assert_array_equal(c[0], c[1])


def _opt():
    return AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50, schedule="wsd")


def test_trainer_steps_equal_the_jax_trainers():
    """3 steps of each package's ``Trainer`` on the audio stream (the JAX
    package on ``xla``, the port on ``torch``) from the same weights and
    data: losses and parameters within 1e-4."""
    import jax

    from repro.training import optimizer as jopt
    from repro.training.data import SyntheticLM as JSyntheticLM
    from repro.training.trainer import TrainConfig as JTrainConfig
    from repro.training.trainer import Trainer as JTrainer

    jcfg, cfg, jp, tp = _carried()
    data = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=BATCH, seed=3,
                with_features=(None, cfg.frontend.feature_dim), labels=True)
    jtr = JTrainer(jcfg, JTrainConfig(opt=jopt.AdamWConfig(**vars(_opt()))), jp,
                   JSyntheticLM(**data))
    tr = Trainer(cfg, TrainConfig(opt=_opt()), tp, SyntheticLM(**data))
    jh, th = jtr.run(3), tr.run(3)
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=TOL)
    for (path, t), j in zip(tree_leaves_with_path(tr.params), jax.tree.leaves(jtr.params)):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=TOL, err_msg=str(path))


def test_checkpoint_restart_repeats_the_losses_bit_for_bit(tmp_path):
    """The port's hubert ``Trainer`` on the kernel backend checkpoints at
    step 3; a fresh ``Trainer`` restores it (weights, moments, the data
    cursor) and repeats steps 4-5's losses exactly."""
    cfg = _narrow("kernel")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    tcfg = TrainConfig(opt=_opt(), ckpt_dir=str(tmp_path), ckpt_every=10**9)
    tr = Trainer(cfg, tcfg, params, _data(cfg, 13, seed=3))
    tr.run(3)
    tr.save(force=True)
    want = [h["loss"] for h in tr.run(2)]
    again = Trainer(cfg, tcfg, params, _data(cfg, 13, seed=3))
    assert again.restore() == 3 and again.step == 3 and again.data.step == 3
    got = [h["loss"] for h in again.run(2)]
    assert all(np.isfinite(got)) and got == want


# ------------------------------------------ launches at published width
@pytest.mark.parametrize("seq_len", [781, 768])
@pytest.mark.parametrize("periods", [1, 2])
def test_kernel_train_step_launches_by_route_at_published_width(periods, seq_len):
    """One kernel-backend train step of hubert-xlarge at published width
    (d_model 1280, 16 heads of 80, d_ff 5120, vocab 504 padded to 512,
    512-d frames),
    ``periods`` layers, 4 crops of ``seq_len`` frames, traced on fake
    tensors by ``tools/train_step_costs.py``: ``native_gemm``'s calls by
    route are 32 a layer, 2 for the
    frontend and 3 for the head, as ``chip_smoke.
    hubert_train_launches_per_step`` derives them.  At 781 frames a bf16
    probability row is 1562 bytes, no multiple of 16, so P.V and the
    three backward products that read P or dS take ``gathered``; at 768
    every attention product takes ``batched``.  At 48 layers the function
    gives 1541 a step."""
    cs = _chip_smoke()
    spec = importlib.util.spec_from_file_location("train_step_costs",
                                                  ROOT / "tools" / "train_step_costs.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg = get_config(ARCH).with_(n_periods=periods)
    got = tool.step_costs(ARCH, 4, seq_len, periods)
    want = cs.hubert_train_launches_per_step(cfg, seq_len, 4)
    assert got["routes"] == want and sum(want.values()) == 32 * periods + 5
    if periods == 1:
        assert want == ({"wgmma": 29, "batched": 3, "gathered": 5} if seq_len == 781
                        else {"wgmma": 29, "batched": 8})
    full = cs.hubert_train_launches_per_step(get_config(ARCH), seq_len, 4)
    assert full == ({"wgmma": 1157, "batched": 144, "gathered": 240} if seq_len == 781
                    else {"wgmma": 1157, "batched": 384})
    assert sum(full.values()) == 1541


# ------------------------------------------- phases 23 and 26 on the CPU
def test_phase_26_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.hubert_train_path`` at the narrow widths in bf16, 2
    crops of 13 frames (the products that read P on ``gathered``) and 16
    for the aligned layouts (``batched``), card-only calls stubbed: every
    check of the phase passes, a step launches 69 (53 ``wgmma``, 6
    ``batched``, 10 ``gathered``), and its record carries the oracle, the
    layouts and the attention comparison."""
    import repro_torch.configs as configs

    cs = _chip_smoke()
    real_get = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda arch, **kw: real_get(arch, **kw).with_(**NARROW))
    monkeypatch.setattr(cs, "HUBERT_TRAIN", dict(cs.HUBERT_TRAIN, seq_len=13, batch=2,
                                                 aligned_len=16))
    counters, profiled = chip_rehearsal.card_stubbed(monkeypatch, cs)
    rec = cs.hubert_train_path(torch.device("cpu"), 0, counters)
    assert rec["launches_per_step"] == {"wgmma": 53, "batched": 6, "gathered": 10}
    assert rec["launches"] == 6 * 69
    assert len(rec["losses"]) == 6 and rec["losses"][-1] < rec["losses"][0]
    assert rec["grad_err"]["float32_kernel"] <= 1e-3
    assert {r["route"] for r in rec["shapes"]} == {"wgmma", "batched", "gathered"}
    assert {r["route"] for r in rec["aligned_shapes"]} == {"batched"}
    assert all(c["aligned"]["routes"] == ["batched"] for c in rec["attention"].values())
    # the scores and dP on batched; P.V and dQ, dV, dK on gathered
    assert {spec: c["crop"]["routes"] for spec, c in rec["attention"].items()} == {
        "bsgrd,btgd->bgrst": ["batched"], "bgrst,btgd->bsgrd": ["gathered"],
        "bsgrd,bgrst->btgd": ["gathered"], "bgrst,bsgrd->btgd": ["gathered"]}
    assert len(profiled) == 2 and rec["weight_cast"]["per_step"] == 4


def test_phase_23_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.ssm_train_path``, which shares phase 26's
    ``train_at_width``: mamba2 smoke at 2 periods in bf16 with SSD chunks
    of 32 (smoke's 16 would send ``CBt`` to ``splitk``), 2 x 128 tokens,
    card-only calls stubbed: every check passes, a step launches 51 (19
    ``wgmma``, 16 ``batched``, 8 ``fbatched``, 8 ``gathered``), and the
    zero ``norm2`` gradient is the one the config gives."""
    import dataclasses

    import repro_torch.configs as configs

    cs = _chip_smoke()
    real_get = configs.get_config

    def smoke(arch, **kw):
        cfg = real_get(arch, smoke=True)
        return cfg.with_(n_periods=2, dtype="bfloat16",
                         ssm=dataclasses.replace(cfg.ssm, chunk=32))

    monkeypatch.setattr(configs, "get_config", smoke)
    monkeypatch.setattr(cs, "SSM_TRAIN", dict(cs.SSM_TRAIN, seq_len=128, batch=2))
    counters, profiled = chip_rehearsal.card_stubbed(monkeypatch, cs)
    rec = cs.ssm_train_path(torch.device("cpu"), 0, counters)
    assert rec["launches_per_step"] == {"wgmma": 19, "batched": 16, "fbatched": 8,
                                        "gathered": 8}
    assert rec["launches"] == 6 * 51 and rec["losses"][-1] < rec["losses"][0]
    assert set(rec["tokens_per_s"]) == {"kernel", "torch"} and len(profiled) == 2


def test_a_step_profile_sums_device_time_by_kind(monkeypatch):
    """``chip_smoke.profile_device`` with ``STEP_KINDS`` sums the device
    time of ``native_gemm``'s kernels (a template's name starts with
    ``void``, a plain function's does not), of the float32 adds, the fills
    and the copies (the weight casts among them); other kernels count in
    none."""
    cs = _chip_smoke()
    spans = [(0.0, 10.0, "void nm_kernel<128, 1>(NmDesc)"),
             (10.0, 14.0, "nm_reduce(float const*, int)"),
             (14.0, 20.0, "void at::native::vectorized_elementwise_kernel<4, "
                          "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >"),
             (20.0, 23.0, "void at::native::vectorized_elementwise_kernel<4, "
                          "at::native::FillFunctor<float>, std::array<char*, 1ul> >"),
             (23.0, 30.0, "void at::native::unrolled_elementwise_kernel<at::native::"
                          "direct_copy_kernel_cuda(at::TensorIteratorBase&)>"),
             (30.0, 31.0, "void at::native::reduce_kernel<512, 1>")]
    monkeypatch.setattr(cs, "device_spans", lambda fn: (spans, 40.0))
    rec = cs.profile_device("a step", lambda: None, kinds=cs.STEP_KINDS)
    assert rec["busy_ms"] == pytest.approx(0.031) and rec["idle_share"] == pytest.approx(0.225)
    assert {k: (pytest.approx(ms), n) for k, (ms, n) in rec["by_kind"].items()} == {
        "native_gemm": (0.014, 2), "f32 adds": (0.006, 1), "fills": (0.003, 1),
        "copies": (0.007, 1)}

