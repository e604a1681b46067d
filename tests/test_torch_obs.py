"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the same inputs.

- Roofline: ``contraction_record`` counts flops and bytes exactly as the
  JAX package does; the bound exists only on a card, from the card's own
  table, and an unknown card raises.
- Copies: ``registry``, ``timeseries`` and ``export`` are the JAX
  package's modules up to import paths and docstrings (their syntax
  trees are compared), and one trace recorded under an injected clock
  exports to the same bytes from both packages.
- Health: the watchdogs raise the same alerts on the same sampler
  sequence; ``NumericsProbe`` flags non-finite torch logits.
- Spans: ``contract`` spans carry the roofline record; on the card their
  ``roofline_fraction`` comes from device time (``gpu``-marked)."""

import ast
import json
import pathlib

import pytest
import torch

from layoutfuzz import gen_layout_case
from repro.core.notation import parse_spec as jparse_spec
from repro.core.table2 import CASES
from repro.obs import export as jexport
from repro.obs import health as jhealth
from repro.obs import registry as jregistry
from repro.obs import roofline as jroofline
from repro.obs import timeseries as jtimeseries
from repro.obs import trace as jtrace
from repro_torch.core.contract import contract
from repro_torch.core.notation import parse_spec
from repro_torch.obs import export, health, registry, roofline, timeseries, trace

# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
H100 = "NVIDIA H100 80GB HBM3"
DIMS = {"m": 6, "n": 10, "p": 3, "k": 5}


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.set_tracer(None)
    jtrace.set_tracer(None)
    yield
    trace.set_tracer(None)
    jtrace.set_tracer(None)


# ------------------------------------------------------------------ roofline
def _record_cases():
    out = [(CASES[label].row_major(), DIMS) for label in sorted(CASES)]
    out += [(cs.spec_str(), dims) for cs, dims, *_ in map(gen_layout_case, range(60))]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contraction_record_counts_like_jax(dtype):
    """flops, bytes and intensity equal the JAX package's exactly for every
    Table II case and a layout-fuzz sample; on the CPU there is no bound."""
    import jax.numpy as jnp

    for spec, dims in _record_cases():
        want = jroofline.contraction_record(jparse_spec(spec), dims, jnp.dtype(dtype))
        got = roofline.contraction_record(parse_spec(spec), dims, getattr(torch, dtype),
                                          torch.device("cpu"))
        for key in ("spec", "dtype", "flops", "bytes", "intensity"):
            assert got[key] == want[key], (spec, key)
        assert "roofline_bound_us" not in got
        assert "roofline_bound_us" not in roofline.contraction_record(
            parse_spec(spec), dims, dtype)


def test_roofline_bound_uses_the_cards_own_ceilings():
    # 1 GB moved, no work: bytes over HBM3's 3.35 TB/s
    us, by = roofline.roofline_bound(0, 1e9, torch.float32, H100)
    assert by == "bytes" and us == pytest.approx(1e9 / 3.35e12 * 1e6)
    # 1 TFLOP of float32 on the FMA units (67 TFLOP/s), bf16 on the tensor cores
    us, by = roofline.roofline_bound(1e12, 1.0, "float32", H100)
    assert by == "operations" and us == pytest.approx(1e12 / 67e12 * 1e6)
    assert roofline.roofline_bound_us(1e12, 1.0, torch.bfloat16, H100) == \
        pytest.approx(1e12 / 989e12 * 1e6)
    assert roofline.device_peaks(H100)["link_bytes_per_s"] == 900e9


def test_unknown_card_raises_naming_the_table():
    with pytest.raises(KeyError, match="DEVICE_PEAKS"):
        roofline.roofline_bound_us(1.0, 1.0, torch.float32, "Some Other GPU")
    with pytest.raises(KeyError, match="DEVICE_PEAKS"):
        roofline.roofline_bound_us(1.0, 1.0, torch.int8, H100)


# ------------------------------------------------------------------- copies
def _tree(path, skip=()):
    """The module's syntax tree without docstrings (and without the
    top-level definitions named in ``skip``), with the package name
    normalised: what must equal between a module and its copy."""
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if getattr(n, "name", None) not in skip]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace("repro_torch", "repro")


@pytest.mark.parametrize("name", ["registry", "timeseries", "export"])
def test_copied_module_is_the_original(name):
    assert _tree(SRC / "repro_torch" / "obs" / f"{name}.py") == \
        _tree(SRC / "repro" / "obs" / f"{name}.py")


def test_health_is_the_original_but_for_the_probe():
    """Everything of ``health.py`` but ``NumericsProbe`` (which reduces
    torch logits) and the ``torch`` import is the JAX package's."""
    mine = ast.parse((SRC / "repro_torch" / "obs" / "health.py").read_text())
    assert any(isinstance(n, ast.Import) and n.names[0].name == "torch" for n in mine.body)
    got = _tree(SRC / "repro_torch" / "obs" / "health.py", skip=("NumericsProbe",))
    want = _tree(SRC / "repro" / "obs" / "health.py", skip=("NumericsProbe",))
    assert got.replace("Import(names=[alias(name='torch')]), ", "") == want


class _Clock:
    """Seconds that advance by a fixed step per reading."""

    def __init__(self, step=1.25e-6):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _record(tr_mod):
    """The same spans and instants on a tracer of ``tr_mod``, under an
    injected clock; one span carries a bound, so it gains a fraction."""
    t = tr_mod.enable_tracing(tr_mod.Tracer(capacity=8, clock=_Clock()))
    for i in range(3):
        with tr_mod.span("decode_batch", "runtime") as sp:
            sp.set(bucket=4, n_active=i + 1)
            with tr_mod.span("contract", "core") as c:
                c.set(spec="mk,kn->mn", dims={"m": 8, "k": 4, "n": 2},
                      flops=128, bytes=224, roofline_bound_us=0.5 * (i + 1))
            tr_mod.instant("tuning_hit", "tuning", winner="auto", measured_us=3.0)
    with tr_mod.span("odd_layer", "custom"):
        pass
    tr_mod.disable_tracing()
    return t


def test_perfetto_export_is_byte_identical(tmp_path):
    """A trace recorded under an injected clock (ring overflowing) writes
    the same Chrome-trace and JSONL bytes from both packages."""
    mine, theirs = _record(trace), _record(jtrace)
    assert mine.dropped == theirs.dropped > 0
    fractions = [e["args"]["roofline_fraction"] for e in mine.events()
                 if e["name"] == "contract"]
    assert fractions and all(f > 0 for f in fractions)
    files = {}
    for name, mod, tr in (("port", export, mine), ("jax", jexport, theirs)):
        mod.write_chrome_trace(str(tmp_path / f"{name}.json"), tr)
        mod.write_jsonl(str(tmp_path / f"{name}.jsonl"), tr)
        files[name] = [(tmp_path / f"{name}.{ext}").read_bytes() for ext in ("json", "jsonl")]
    assert files["port"] == files["jax"]
    stats = export.validate_chrome_trace(str(tmp_path / "port.json"))
    assert "contract" in stats["names"]
    export.main(["--validate", str(tmp_path / "port.json"), "--require-cat", "core",
                 "--require-name", "contract"])


def test_registry_and_sampler_match_the_original():
    regs = {}
    for name, reg_mod, ts_mod in (("port", registry, timeseries),
                                  ("jax", jregistry, jtimeseries)):
        reg = reg_mod.MetricsRegistry()
        state = {"n": 0}
        reg.register("serving", lambda s=state: {"ticks": s["n"], "ok": True, "name": "x"})
        reg.register("broken", lambda: 1 / 0)
        sampler = ts_mod.MetricsSampler(reg, clock=_Clock(0.5),
                                        hist_metrics=("serving.ticks",))
        for i in range(7):
            state["n"] = i * i
            reg.counter("events", 2)
            sampler.maybe_sample()
        regs[name] = (reg.snapshot(), sampler.stats(), sampler.prometheus_text(),
                      sampler.get("serving.ticks").points())
    assert regs["port"] == regs["jax"]


# ------------------------------------------------------------------- health
def _scripted_alerts(h_mod, r_mod, t_mod):
    """Run the default watchdog pack over one scripted run: healthy decode,
    a stall, recovery, a recompile storm and page-pool pressure."""
    state = {"ticks": 0, "toks": 0, "done": 0, "compiles": 0, "free": 90, "total": 100}
    reg = r_mod.MetricsRegistry()
    reg.register("serving", lambda: {"ticks": state["ticks"], "tokens_out": state["toks"],
                                     "requests_done": state["done"]})
    reg.register("buckets", lambda: {"bucket_compiles": state["compiles"]})
    reg.register("pages", lambda: {"pages_free": state["free"],
                                   "pages_total": state["total"]})
    mon = h_mod.HealthMonitor(t_mod.MetricsSampler(reg, clock=_Clock(1.0)),
                              clock=_Clock(1.0))
    fired = []
    for step in range(40):
        state["ticks"] += 1
        if not 10 <= step < 22:               # a stall of 12 samples
            state["toks"] += 3
            if step % 7 == 0:
                state["done"] += 1
        if step < 3 or 25 <= step < 28:       # warm-up compiles, then a storm
            state["compiles"] += 1
        state["free"] = 90 - 3 * step if step < 30 else 50
        fired += [(a.name, a.severity, a.message, a.attrs, a.t) for a in mon.tick()]
    return fired, mon.stats()


def test_watchdogs_raise_the_same_alerts():
    mine = _scripted_alerts(health, registry, timeseries)
    theirs = _scripted_alerts(jhealth, jregistry, jtimeseries)
    assert mine == theirs
    assert {name for name, *_ in mine[0]} == {"decode_stall", "recompile_storm",
                                              "pool_pressure"}


def _monitor():
    return health.HealthMonitor(timeseries.MetricsSampler(registry.MetricsRegistry(),
                                                          clock=_Clock()), watchdogs=[])


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_numerics_probe_flags_torch_nonfinite(bad):
    mon = _monitor()
    probe = health.NumericsProbe(mon, every=2)
    logits = torch.ones(2, 5)
    probe(logits)
    probe(logits)                 # probed, finite
    logits[1, 3] = bad
    probe(logits)                 # not probed (every 2nd call)
    assert probe.probes == 1 and probe.failures == 0
    probe(logits)
    assert probe.probes == 2 and probe.failures == 1
    (alert,) = mon.alerts
    assert (alert.name, alert.severity) == ("nonfinite_logits", "critical")


def test_attach_wires_a_stub_runtime():
    class StubRuntime:
        logits_probe = None

        def __init__(self):
            self.registries = []

        def register_metrics(self, reg):
            self.registries.append(reg)
            reg.register("serving", lambda: {"ticks": 0, "tokens_out": 0})

    rt, mon = StubRuntime(), _monitor()
    mon.attach(rt)
    assert rt.registries == [mon.sampler.registry] and rt.logits_probe is None
    mon.attach(rt, numerics_every=3)
    assert rt.logits_probe is mon.probe and mon.probe.every == 3
    mon.register()
    assert {"health", "timeseries", "serving"} <= set(mon.sampler.registry.snapshot())
    assert mon.stats()["numerics_probes"] == 0


def test_attach_wires_the_ports_serving_runtime():
    """As the JAX package's ``tests/test_health.py`` does with its runtime:
    ``attach`` installs the probe on a real runtime's decode loop."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.engine import ServingRuntime
    from repro_torch.runtime.scheduler import Request

    cfg = get_config("minicpm-2b", smoke=True).with_(n_periods=1)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    rt = ServingRuntime(cfg, params, slots=2, max_len=64, prefill_chunk=8,
                        precompile=False)
    mon = _monitor()
    mon.attach(rt, numerics_every=1)
    assert rt.logits_probe is mon.probe
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=5).astype(np.int32)
    rt.serve([Request(rid=0, prompt=prompt, max_new_tokens=3)])
    assert mon.probe.calls >= 1        # decode launches hit the probe
    assert mon.probe.failures == 0     # real logits are finite
    assert mon.stats()["numerics_probes"] == mon.probe.probes
    mon.register()
    snap = mon.sampler.registry.snapshot()
    assert snap["serving"]["tokens_out"] == 3 and "buckets" in snap


# -------------------------------------------------------------------- spans
def test_contract_span_carries_the_record_and_no_cpu_fraction():
    A, B = torch.randn(6, 5), torch.randn(5, 10)
    t = trace.enable_tracing(trace.Tracer())
    contract("mk,kn->mn", A, B, backend="kernel")
    trace.disable_tracing()
    (ev,) = [e for e in t.events() if e["name"] == "contract"]
    args = ev["args"]
    assert (args["flops"], args["bytes"]) == (2 * 6 * 5 * 10, 4 * (30 + 50 + 60))
    assert args["dims"] == {"m": 6, "k": 5, "n": 10} and args["backend"] == "kernel"
    assert "roofline_bound_us" not in args and "roofline_fraction" not in args
    assert "device_us" not in args


def test_host_span_with_a_bound_gets_its_fraction_at_exit():
    t = trace.Tracer(clock=_Clock(2e-6))
    with t.span("work", "app") as sp:
        sp.set(roofline_bound_us=1.0)
    (ev,) = t.events()
    assert ev["args"]["roofline_fraction"] == pytest.approx(1.0 / ev["dur"])


@pytest.mark.gpu
def test_roofline_fraction_from_device_time():
    """On the card a ``contract`` span times its body with CUDA events:
    ``device_us`` and a fraction in (0, 1.05] of its bound, resolved when
    the events are read, even though the host returned at the enqueue."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device time exists only there")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    T = torch.randn(256, 256, 256, device=dev, generator=g)
    C = torch.randn(256, 10, device=dev, generator=g)
    contract("mnp,pk->mnk", T, C, backend="kernel")      # build and warm
    torch.cuda.synchronize()
    t = trace.enable_tracing(trace.Tracer())
    for _ in range(3):
        contract("mnp,pk->mnk", T, C, backend="kernel")
    trace.disable_tracing()
    spans = [e for e in t.events() if e["name"] == "contract"]
    assert len(spans) == 3
    for ev in spans:
        args = ev["args"]
        assert args["roofline_bound_us"] > 0 and args["device_us"] > 0
        assert 0 < args["roofline_fraction"] <= 1.05
        assert args["roofline_fraction"] == pytest.approx(
            args["roofline_bound_us"] / args["device_us"])
    json.dumps(export.chrome_trace(t))
