"""Post-heal state-driven sync via join decomposition — counterpart of the
JAX package's ``delta_opt/heal.py``.

A lossy δ run voids its residue certificate and leaves every rank's rows
valid partial states; heal is state-driven resync. Full-state gossip
ships P whole states to re-converge a mesh that usually diverged by a
handful of rows. :func:`resync` is the bandwidth-optimal form Enes et
al. §4 prescribe: each rank decomposes its state over ``since`` — the
last mutually known state, e.g. a pre-partition certified fixpoint — and
ships only the divergence lanes; reconstruction plus the kind's own join
lands bit-identically on the full-state fixpoint.

``since`` must be a lower bound of every rank's state (the join identity
always is, at the price of shipping everything). A wrong ``since`` still
reconstructs each rank bit-exactly; it just stops being minimal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._dtypes import bits
from ..ops.lattice import tree_leaves, tree_map
from ..utils.metrics import metrics, state_nbytes
from .decompose import decompose, decomposition_bytes, get_decomposer, reconstruct


class ResyncReport(NamedTuple):
    """Byte accounting for one decomposition resync."""

    ranks: int
    lanes_shipped: int        # valid δ lanes across every rank
    bytes_shipped: float      # decomposition payload (bytes_useful form)
    bytes_full_state: float   # what full-state resync would have shipped
    ratio: float              # shipped / full — the headline quantity


def _rank(states, q: int):
    return tree_map(lambda x: x[q], states)


def resync(kind: str, states, since):
    """Decomposition-based state-driven resync over a ``[P, ...]`` rank
    batch: decompose every rank over ``since``, "ship" the lanes (counted
    as valid lanes plus residuals), reconstruct, and fold with the kind's
    join as a left-to-right chain over the ranks — the JAX package's scan
    order, on which the bits depend (plain pairwise joins). Returns
    ``(healed [P, ...], ResyncReport)``: ``healed`` is the full-join
    fixpoint on every rank.

    Counters: ``delta_opt.resync_runs``, ``delta_opt.resync_bytes_shipped``
    (and ``.<kind>``), ``delta_opt.resync_bytes_full``."""
    dec = get_decomposer(kind)
    p = tree_leaves(states)[0].shape[0]

    decs = [decompose(dec, _rank(states, q), since) for q in range(p)]
    shipped = float(torch.stack([decomposition_bytes(d) for d in decs]).sum())
    lanes = int(sum(d.valid.sum() for d in decs))
    recon = [reconstruct(dec, since, d) for d in decs]

    def join(a, b):
        out = dec.join(a, b)
        return out[0] if isinstance(out, tuple) and len(out) == 2 else out

    acc = recon[0]
    for row in recon[1:]:
        acc = join(acc, row)
    healed = tree_map(lambda x: bits(x).expand(p, *x.shape).contiguous().view(x.dtype), acc)

    full = float(p * state_nbytes(_rank(states, 0)))
    report = ResyncReport(ranks=p, lanes_shipped=lanes, bytes_shipped=shipped,
                          bytes_full_state=full, ratio=shipped / full if full else 0.0)
    metrics.count("delta_opt.resync_runs")
    metrics.count("delta_opt.resync_bytes_shipped", int(shipped))
    metrics.count(f"delta_opt.resync_bytes_shipped.{kind}", int(shipped))
    metrics.count("delta_opt.resync_bytes_full", int(full))
    return healed, report


__all__ = ["ResyncReport", "resync"]
