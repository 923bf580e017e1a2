"""Process-global configuration of the port — counterpart of the JAX
package's ``config.py``, with its fields and validation rules:

- ``backend`` — what :func:`replicaset` hands out: ``"pure"`` a list of
  sequential oracle objects (``crdt_tpu_torch.pure``), ``"xla"`` (the
  JAX package's name, kept so ``configure(backend=...)`` reads the same
  against either package) one batched device model of the port
  (``crdt_tpu_torch.models``), on ``device=``;
- ``strict`` — validate every op's dot against the replica's top clock
  before applying it (``models/validation.py``);
- ``deferred_cap`` / ``sibling_cap`` — the static capacities the batched
  models are built with;
- ``debug_numerics`` — validated and stored; it changes nothing on the
  port's kinds, whose lanes are integers (the JAX flag turns on its NaN
  checks);
- ``counter_dtype`` — the lane width of the clock family
  (``ops/vclock.counter_dtype``; the ORSWOT dot slabs are always u32).

Usage::

    from crdt_tpu_torch.config import config, configure, configured, replicaset

    configure(backend="xla", strict=True)
    replicas = replicaset("orswot", n_replicas=8, n_members=64, n_actors=8)
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional


@dataclasses.dataclass
class Config:
    backend: str = "xla"
    strict: bool = False
    deferred_cap: int = 8
    sibling_cap: int = 8
    debug_numerics: bool = False
    counter_dtype: str = "uint32"

    def validate(self) -> None:
        if self.backend not in ("pure", "xla"):
            raise ValueError(f"backend must be 'pure' or 'xla', got {self.backend!r}")
        if self.deferred_cap < 1 or self.sibling_cap < 1:
            raise ValueError("capacities must be >= 1")
        if self.counter_dtype not in ("uint32", "uint64"):
            raise ValueError(
                f"counter_dtype must be 'uint32' or 'uint64', got {self.counter_dtype!r}"
            )


config = Config()


def configure(**kwargs) -> Config:
    """Update the global config in place (unknown keys rejected)."""
    for key, value in kwargs.items():
        if not hasattr(config, key):
            raise TypeError(f"unknown config field {key!r}")
        setattr(config, key, value)
    config.validate()
    return config


@contextlib.contextmanager
def configured(**kwargs) -> Iterator[Config]:
    """Scoped config override (restores previous values on exit)."""
    saved = dataclasses.replace(config)
    try:
        yield configure(**kwargs)
    finally:
        configure(**dataclasses.asdict(saved))


def _pure_factories() -> dict:
    from .pure.gcounter import GCounter
    from .pure.gset import GSet
    from .pure.lwwreg import LWWReg
    from .pure.map import Map
    from .pure.mvreg import MVReg
    from .pure.orswot import Orswot
    from .pure.pncounter import PNCounter

    return {
        "orswot": Orswot,
        "map": lambda: Map(val_default=MVReg),
        "map_orswot": lambda: Map(val_default=Orswot),
        "map_map": lambda: Map(val_default=lambda: Map(val_default=MVReg)),
        "map3": lambda: Map(val_default=lambda: Map(val_default=Orswot)),
        "gcounter": GCounter,
        "pncounter": PNCounter,
        "gset": GSet,
        "lwwreg": LWWReg,
        "mvreg": MVReg,
        "sparse_orswot": Orswot,  # same oracle; sparsity is a backend trait
        "sparse_map_orswot": lambda: Map(val_default=Orswot),
        "sparse_map": lambda: Map(val_default=MVReg),
        "sparse_map_map": lambda: Map(val_default=lambda: Map(val_default=MVReg)),
    }


def replicaset(
    kind: str,
    n_replicas: int,
    *,
    n_members: Optional[int] = None,
    n_actors: Optional[int] = None,
    n_keys: Optional[int] = None,
    n_keys2: Optional[int] = None,
    device="cuda",
):
    """The backend-selecting factory: N replicas of ``kind`` under the
    configured backend — a list of oracle objects for ``pure``, one
    batched model on ``device`` for ``xla``. The fourteen kinds, their
    defaults and lane sizing are the JAX package's: ``n_keys`` sizes the
    (outer) key axis, ``n_members`` the inner axis of the nested kinds
    (the member universe of map_orswot, K2 of map_map), ``n_keys2`` the
    K2 axis of map3, ``n_actors`` the actor lanes. The sparse kinds
    repurpose lanes: ``sparse_orswot`` takes ``n_members`` as the
    live-dot capacity; ``sparse_map_orswot`` ``n_members`` as the
    per-key span and ``n_keys2`` as the live-dot capacity; ``sparse_map``
    ``n_keys`` as the (virtual) key universe bound and ``n_keys2`` as the
    live-cell capacity; ``sparse_map_map`` ``n_members`` as the inner-key
    span and ``n_keys2`` as the live-cell capacity."""
    config.validate()
    if config.backend == "pure":
        factories = _pure_factories()
        if kind not in factories:
            raise ValueError(f"unknown replicaset kind {kind!r}")
        return [factories[kind]() for _ in range(n_replicas)]

    from . import models as m

    dev = dict(device=device)
    na = n_actors or 16
    build = {
        "orswot": lambda: m.BatchedOrswot(n_replicas, n_members or 64, na, config.deferred_cap,
                                          **dev),
        "sparse_orswot": lambda: m.BatchedSparseOrswot(n_replicas, n_members or 256, na,
                                                       config.deferred_cap, **dev),
        "sparse_map_orswot": lambda: m.BatchedSparseMapOrswot(
            n_replicas, n_members or 64, n_keys2 or 256, na, config.deferred_cap,
            key_deferred_cap=config.deferred_cap, **dev),
        "sparse_map_map": lambda: m.BatchedSparseNestedMap(
            n_replicas, span=n_members or 1 << 16, cell_cap=n_keys2 or 256, n_actors=na,
            sibling_cap=config.sibling_cap, deferred_cap=config.deferred_cap,
            key_deferred_cap=config.deferred_cap, **dev),
        # The widest key universe an int32 packed cell key holds.
        "sparse_map": lambda: m.BatchedSparseMap(
            n_replicas, n_keys or (2**31 - 1) // na, na, n_keys2 or 256, config.sibling_cap,
            config.deferred_cap, **dev),
        "map": lambda: m.BatchedMap(n_replicas, n_keys or 64, na, config.sibling_cap,
                                    config.deferred_cap, **dev),
        "map_orswot": lambda: m.BatchedMapOrswot(n_replicas, n_keys or 16, n_members or 16, na,
                                                 config.deferred_cap, **dev),
        "map_map": lambda: m.BatchedNestedMap(n_replicas, n_keys or 16, n_members or 16, na,
                                              config.sibling_cap, config.deferred_cap, **dev),
        "map3": lambda: m.BatchedMap3(n_replicas, n_keys or 8, n_keys2 or 8, n_members or 8, na,
                                      config.deferred_cap, **dev),
        "gcounter": lambda: m.BatchedGCounter(n_replicas, n_actors=na, **dev),
        "pncounter": lambda: m.BatchedPNCounter(n_replicas, n_actors=na, **dev),
        "gset": lambda: m.BatchedGSet(n_replicas, n_members or 64, **dev),
        "lwwreg": lambda: m.BatchedLWWReg(n_replicas, **dev),
        "mvreg": lambda: m.BatchedMVReg(n_replicas, na, config.sibling_cap, **dev),
    }
    if kind not in build:
        raise ValueError(f"unknown replicaset kind {kind!r}")
    return build[kind]()


__all__ = ["Config", "config", "configure", "configured", "replicaset"]
