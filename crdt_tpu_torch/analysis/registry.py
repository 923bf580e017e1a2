"""The kind registry the law engine and the SEC schedule checker iterate
— the port of the merge-kind and geo-surface parts of the JAX package's
``analysis/registry.py``.

The JAX package fills its registries at import time (each op module calls
``register_merge``, each geo module ``register_geo_surface``). The port
keeps tables instead, as ``delta_opt.decompose.KINDS`` keeps the
decomposers: :func:`merge_kinds` builds the table of the twelve merge
kinds on first use (the op modules are imported then, not when this
module loads), and :data:`GEO_SURFACES` lists the geo package's operational
symbols. The joins, the decomposers, the compactors and the
flight-recorder event schemas are not copied here: the law engine reads
the port's one table of each (``delta_opt.decompose.KINDS``,
``delta_opt.decompose.compactors()``, ``obs.events.EVENTS``), and :func:`undecomposable_kinds` /
:func:`uncompactable_kinds` hold those tables against the merge kinds.

Every generator of a :class:`MergeKind` takes ``device=`` (the states it
mints live there), so the same engine runs on the card and on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MergeKind:
    """One lattice: the unit the law engine checks.

    - ``join(a, b) -> state | (state, flags)``, over any leading batch
      axes;
    - ``states(device) -> [identity, s1, ...]`` — the small domain, states
      reachable from the identity through CmRDT ops with capacity headroom;
    - ``canon(state) -> state`` where raw slot order depends on join
      operand order (None: raw arrays are canonical);
    - ``big_states(device)`` — an optional property-sampled larger domain;
    - ``deltas(device) -> [(origin, δ-state), ...]`` and ``apply(state, δ)``
      — the SEC schedule checker's hooks (``schedules.py``): the δ set to
      deliver, and op-based delivery for a kind whose ops are not joins.
    """

    name: str
    join: Callable[[Any, Any], Any]
    states: Callable[..., list]
    canon: Optional[Callable[[Any], Any]] = None
    big_states: Optional[Callable[..., list]] = None
    module: str = ""
    deltas: Optional[Callable[..., list]] = None
    apply: Optional[Callable[[Any, Any], Any]] = None


@dataclass(frozen=True)
class GeoSurface:
    """One public operational symbol of the geo-federation plane
    (``crdt_tpu_torch.geo``). The ``federation`` static-check section
    fails for a public geo symbol missing from :data:`GEO_SURFACES`."""

    name: str
    module: str = ""


_P = "crdt_tpu_torch."


def _merge_table() -> Dict[str, MergeKind]:
    """Each kind's join is the decomposer table's (``KINDS[name].join``),
    but for ``sparse_nested_map``, whose law domain is checked under
    ``sparse_nest._law_join``; this table adds only the ``_law_*``
    generators beside each kind's ops."""
    from ..delta_opt.decompose import KINDS
    from ..ops import map as map_ops
    from ..ops import (
        gset, lwwreg, map3, map_map, map_orswot, mvreg, orswot, sparse_mvmap, sparse_nest,
        sparse_orswot, vclock,
    )

    def kind(name, mod, join=None, **kw):
        return MergeKind(name=name, join=join or KINDS[name].join, states=mod._law_states,
                         module=mod.__name__, **kw)

    rows = (
        kind("gset", gset),
        kind("lwwreg", lwwreg),
        kind("map", map_ops, canon=map_ops._law_canon),
        kind("map3", map3, canon=map3._law_canon),
        kind("map_map", map_map, canon=map_map._law_canon),
        kind("map_orswot", map_orswot, canon=map_orswot._law_canon),
        kind("mvreg", mvreg, canon=mvreg._law_canon),
        kind("orswot", orswot, canon=orswot._law_canon,
             big_states=orswot._law_states_big, deltas=orswot._law_deltas),
        kind("sparse_mvmap", sparse_mvmap, canon=sparse_mvmap._law_canon),
        kind("sparse_nested_map", sparse_nest, sparse_nest._law_join,
             canon=sparse_nest._law_canon),
        kind("sparse_orswot", sparse_orswot, canon=sparse_orswot._law_canon,
             big_states=sparse_orswot._law_states_big),
        kind("vclock", vclock),
    )
    return {k.name: k for k in rows}


_MERGE: Dict[str, MergeKind] = {}


def merge_kinds() -> Tuple[MergeKind, ...]:
    """Every merge kind, sorted by name (the JAX registry's order)."""
    if not _MERGE:
        _MERGE.update(_merge_table())
    return tuple(_MERGE[k] for k in sorted(_MERGE))


def get_merge_kind(name: str) -> MergeKind:
    merge_kinds()
    return _MERGE[name]


def undecomposable_kinds() -> List[str]:
    from ..delta_opt.decompose import KINDS

    return sorted({k.name for k in merge_kinds()} - set(KINDS))


def uncompactable_kinds() -> List[str]:
    from ..delta_opt.decompose import compactors

    return sorted({k.name for k in merge_kinds()} - set(compactors()))


# ---- the geo-federation surfaces -------------------------------------------

GEO_SURFACES: Tuple[GeoSurface, ...] = tuple(
    GeoSurface(name, _P + "geo") for name in (
        "RegionMap", "FederationMembership", "RegionPlane", "Federation",
        "GeoLink", "link_for", "build_packet", "apply_packet", "exchange",
        "exchange_all", "read_local", "watermark_reads_sound",
        "fail_over_region", "static_checks",
    )
)


def geo_surfaces() -> Tuple[GeoSurface, ...]:
    return tuple(sorted(GEO_SURFACES, key=lambda s: s.name))


def _unregistered_package_surfaces(pkg_name: str, registered) -> List[str]:
    """Public operational symbols of one package that are not in its
    table: the package surface plus every submodule's own definitions, so
    a symbol that skipped the ``__init__`` re-export list cannot hide.
    Pure data carriers are exempt: NamedTuple reports, dataclass
    certificates and exception types are results, not surfaces."""
    import dataclasses
    import importlib
    import inspect
    import pkgutil

    pkg = importlib.import_module(pkg_name)

    def is_surface(n: str, obj) -> bool:
        if n.startswith("_") or not callable(obj):
            return False
        if inspect.isclass(obj):
            if issubclass(obj, BaseException):
                return False
            if hasattr(obj, "_fields") or dataclasses.is_dataclass(obj):
                return False
        return getattr(obj, "__module__", "").startswith(pkg_name)

    found = {n for n in dir(pkg) if is_surface(n, getattr(pkg, n))}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg_name}.{info.name}")
        for n in dir(mod):
            obj = getattr(mod, n)
            if is_surface(n, obj) and getattr(obj, "__module__", "") == mod.__name__:
                found.add(n)
    return sorted(found - set(registered))


def unregistered_geo_surfaces() -> List[str]:
    """Public operational ``crdt_tpu_torch.geo`` symbols missing from
    :data:`GEO_SURFACES` — the discovery gate of the ``federation``
    static-check section."""
    return _unregistered_package_surfaces(_P + "geo", {s.name for s in GEO_SURFACES})


__all__ = [
    "GEO_SURFACES", "GeoSurface", "MergeKind", "geo_surfaces", "get_merge_kind", "merge_kinds",
    "uncompactable_kinds", "undecomposable_kinds", "unregistered_geo_surfaces",
]
