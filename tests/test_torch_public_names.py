"""Each subpackage of the port re-exports the JAX package's package-level
names, under the same names, from its own modules; the JAX-only names
(shardings) are left out. Importing the top-level port
package loads no torch."""

import importlib
import subprocess
import sys

import pytest

# JAX package-level names with no torch meaning, left out of the port
_JAX_ONLY = {"parallel": {"batch_sharding"}}


def _jax_names(sub):
    """The names the JAX subpackage's ``__init__.py`` imports from its modules."""
    jax_pkg = importlib.import_module(f"twotowermlretrieval_tpu.{sub}")
    prefix = f"twotowermlretrieval_tpu.{sub}."
    return {n for n, v in vars(jax_pkg).items() if not n.startswith("_")
            and getattr(v, "__module__", "").startswith(prefix)}


@pytest.mark.parametrize("sub", ["data", "models", "train", "parallel", "serve"])
def test_subpackage_exports_the_jax_names(sub):
    want = _jax_names(sub) - _JAX_ONLY.get(sub, set())
    assert want, sub
    port = importlib.import_module(f"twotowermlretrieval_tpu_torch.{sub}")
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, (sub, missing)
    for name in want:  # each from one of the port's own modules
        obj = getattr(port, name)
        assert obj.__module__.startswith(f"twotowermlretrieval_tpu_torch.{sub}."), (name, obj)
    # `from ... import name` works too (the lazily served names included)
    ns = {}
    exec(f"from twotowermlretrieval_tpu_torch.{sub} import {', '.join(sorted(want))}", ns)


def test_jax_only_names_are_left_out():
    """``batch_sharding`` (a ``NamedSharding``) has no torch meaning: JAX's
    ``parallel`` exports it, the port's does not, and the lazy lookup
    raises as for any missing name."""
    import twotowermlretrieval_tpu_torch.parallel as parallel

    assert "batch_sharding" in _jax_names("parallel")
    with pytest.raises(AttributeError):
        parallel.batch_sharding  # noqa: B018


def test_top_level_import_loads_no_torch():
    code = ("import sys, twotowermlretrieval_tpu_torch as p; "
            "assert p.Config; print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
