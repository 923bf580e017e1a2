"""The port's configuration (``crdt_tpu_torch.config``) against the JAX
package's ``config.py``: the same fields, defaults and validation, and
``replicaset`` for all fourteen kinds under both backends — the same
oracle classes for ``pure``, and for ``xla`` the same batched model
class with every state tensor at the JAX path, shape and dtype (the
lane repurposing of the sparse kinds included), on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from crdt_tpu import config as ref_config
from crdt_tpu_torch import config

KINDS = ["orswot", "sparse_orswot", "map", "map_orswot", "map_map", "map3",
         "sparse_map_orswot", "sparse_map", "sparse_map_map", "gcounter", "pncounter", "gset",
         "lwwreg", "mvreg"]
SIZES = [dict(), dict(n_members=4, n_actors=2, n_keys=4),
         dict(n_members=6, n_actors=3, n_keys=5, n_keys2=7)]


def _arrays(obj, path="", depth=0):
    """``{attribute path: (shape, dtype)}`` of every array a model holds
    (its state tuples walked by field, its sub-models by attribute)."""
    out = {}
    if isinstance(obj, (torch.Tensor, jax.Array)):
        dt = str(obj.dtype).replace("torch.", "")
        out[path] = (tuple(obj.shape), dt)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for f in obj._fields:
            out.update(_arrays(getattr(obj, f), f"{path}.{f}", depth))
    elif depth < 2 and hasattr(obj, "__dict__") and not isinstance(obj, type):
        for k, v in vars(obj).items():
            if not k.startswith("_"):
                out.update(_arrays(v, f"{path}.{k}", depth + 1))
    return out


def test_the_config_has_the_jax_fields_defaults_and_rules():
    assert [f.name for f in dataclasses.fields(config.Config)] == \
        [f.name for f in dataclasses.fields(ref_config.Config)]
    assert dataclasses.asdict(config.Config()) == dataclasses.asdict(ref_config.Config())
    for bad in (dict(backend="cuda"), dict(deferred_cap=0), dict(sibling_cap=0),
                dict(counter_dtype="int8")):
        with pytest.raises(ValueError) as got:
            config.Config(**bad).validate()
        with pytest.raises(ValueError) as want:
            ref_config.Config(**bad).validate()
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError):
        config.configure(no_such_flag=True)
    before = config.config.backend
    with config.configured(backend="pure", debug_numerics=True):
        assert config.config.backend == "pure" and config.config.debug_numerics
    assert config.config.backend == before and not config.config.debug_numerics
    assert "replicaset" in config.__all__


@pytest.mark.parametrize("kind", KINDS)
def test_a_pure_replicaset_is_a_list_of_the_jax_oracles(kind):
    with config.configured(backend="pure"), ref_config.configured(backend="pure"):
        got, want = config.replicaset(kind, 3), ref_config.replicaset(kind, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert type(g).__module__.replace("crdt_tpu_torch", "crdt_tpu") == type(w).__module__
        if hasattr(w, "val_default"):
            assert type(g.val_default()).__name__ == type(w.val_default()).__name__


@pytest.mark.parametrize("sizes", SIZES, ids=["defaults", "small", "nested"])
@pytest.mark.parametrize("kind", KINDS)
def test_an_xla_replicaset_is_the_jax_model_at_its_shapes(kind, sizes):
    caps = dict(backend="xla", deferred_cap=3, sibling_cap=5)
    with config.configured(**caps), ref_config.configured(**caps):
        got = config.replicaset(kind, 2, device="cpu", **sizes)
        want = ref_config.replicaset(kind, 2, **sizes)
    assert type(got).__name__ == type(want).__name__
    assert got.n_replicas == want.n_replicas == 2
    g, w = _arrays(got), _arrays(want)
    assert g == w, kind
    assert g and all(np.prod(shape) > 0 for shape, _ in g.values())
    for arr in (x for x in vars(got).values() if isinstance(x, torch.Tensor)):
        assert arr.device.type == "cpu"


def test_unknown_kinds_are_refused_under_both_backends():
    for backend in ("pure", "xla"):
        with config.configured(backend=backend):
            with pytest.raises(ValueError, match="unknown replicaset kind"):
                config.replicaset("btree", 2, device="cpu")
