"""The port's model configs (``repro_torch.configs``) against the JAX
package's (``repro.configs``).

- Every architecture, full and smoke: the same fields with the same
  values (the backend under its port name) and the same ``param_count``.
- The copied modules equal their originals by syntax tree (docstrings
  dropped, the package name normalised), up to the differences listed
  here: ``configs/base.py`` returns a ``torch.dtype`` and names the
  port's default backend; ``training/data.py`` gives meta tensors for
  batch specs; ``runtime/metrics.py``, ``runtime/buckets.py`` and
  ``serving/engine.py`` differ in nothing else."""

import ast
import dataclasses
import difflib
import pathlib

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.registry import VOCAB_PAD

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

#: the port's backend names for the JAX package's
BACKEND = {"xla": "torch", "pallas": "kernel"}


def as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_the_same_architectures():
    assert list_archs() == jlist_archs() and len(list_archs()) == 10


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_config_equals_the_jax_packages(arch, smoke):
    mine, ref = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    want = as_dict(ref) | {"contract_backend": BACKEND[ref.contract_backend]}
    assert as_dict(mine) == want
    assert (mine.n_layers, mine.hd) == (ref.n_layers, ref.hd)
    for active in (False, True):
        assert mine.param_count(active_only=active) == ref.param_count(active_only=active)
    assert mine.activation_dtype() == getattr(torch, ref.dtype)
    if not smoke:
        assert mine.vocab_size % VOCAB_PAD == 0


def test_overrides_and_unknown_arch():
    cfg = get_config("internlm2-20b", contract_backend="kernel", n_periods=4)
    assert (cfg.contract_backend, cfg.n_periods, cfg.d_model) == ("kernel", 4, 6144)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")


def _source(path):
    """The module's source with docstrings dropped and the package name
    normalised, one statement per line (``ast.unparse``)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.unparse(tree).replace("repro_torch", "repro").splitlines()


COPIES = {
    "configs/base.py": [
        "- import jax.numpy as jnp",
        "+ import torch",
        "-     contract_backend: str = 'xla'",
        "+     contract_backend: str = 'torch'",
        "-         return jnp.dtype(self.dtype)",
        "+         return getattr(torch, self.dtype)",
    ],
    "runtime/metrics.py": [],
    "training/data.py": [
        "-     import jax",
        "+     import torch",
        "-     specs = {'tokens': jax.ShapeDtypeStruct((B, S), np.int32)}",
        "+     specs = {'tokens': torch.empty((B, S), dtype=torch.int32, device='meta')}",
        "-         specs['features'] = jax.ShapeDtypeStruct((B, n, cfg.frontend.feature_dim), "
        "np.float32)",
        "+         specs['features'] = torch.empty((B, n, cfg.frontend.feature_dim), "
        "dtype=torch.float32, device='meta')",
        "-         specs['labels'] = jax.ShapeDtypeStruct((B, S), np.int32)",
        "+         specs['labels'] = torch.empty((B, S), dtype=torch.int32, device='meta')",
    ],
    "runtime/buckets.py": [],
    "serving/engine.py": [],
    **{f"configs/{p.name}": [] for p in sorted((SRC / "repro" / "configs").glob("*.py"))
       if p.name != "base.py"},
}


@pytest.mark.parametrize("module", sorted(COPIES))
def test_copied_module_differs_only_as_listed(module):
    got = _source(SRC / "repro_torch" / module)
    want = _source(SRC / "repro" / module)
    diff = [line for line in difflib.ndiff(want, got) if line[:1] in "+-"]
    assert diff == COPIES[module]
