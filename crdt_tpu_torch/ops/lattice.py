"""Shared lattice-reduction machinery.

``tree_fold`` collapses a replica batch (leading axis) with any pairwise
lattice join in a log2 reduction tree — sound because the join is
associative, commutative and idempotent. The batch is padded to a power
of two with join identities, which the join absorbs. States are
NamedTuples of tensors; ``join`` broadcasts over leading batch axes
(the JAX package's ``jax.vmap(join)`` becomes a join on batched
leaves). Beside it, the tree walks (``tree_map``, ``tree_leaves``,
``tree_unflatten``) and the row gathers and scatters every packet and
window function shares (``take_rows``, ``put_rows``, ``mask_slots``).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from .._dtypes import bits


def tree_map(fn: Callable, *trees):
    """Apply ``fn`` leaf-wise over NamedTuples/tuples of tensors."""
    first = trees[0]
    if isinstance(first, tuple):
        out = [tree_map(fn, *kids) for kids in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensors of a (nested) NamedTuple/tuple, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for x in tree for leaf in tree_leaves(x)]


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` in
    :func:`tree_leaves` order (the inverse of that walk)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            leaf = next(it, None)
            if leaf is None:
                raise ValueError("fewer leaves than the template has")
            return leaf
        kids = [build(x) for x in node]
        return type(node)(*kids) if hasattr(node, "_fields") else tuple(kids)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def row_index(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``idx [.., C]`` expanded over the trailing axes of ``x [.., E, ...]``
    for a gather/scatter along the row axis."""
    extra = x.dim() - idx.dim()
    return idx.long().reshape(*idx.shape, *([1] * extra)).expand(*idx.shape, *x.shape[idx.dim():])


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx [.., C]`` of ``x [.., E, ...]`` (any lane dtype)."""
    return torch.gather(bits(x), idx.dim() - 1, row_index(x, idx)).view(x.dtype)


def put_rows(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with rows ``idx`` set to ``v`` (indices distinct)."""
    return torch.scatter(bits(x), idx.dim() - 1, row_index(x, idx), bits(v)).view(x.dtype)


def mask_slots(keep: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x [.., C, ...]`` with the slots ``keep [.., C]`` leaves out zeroed
    (any lane dtype, bool included)."""
    sel = keep.reshape(*keep.shape, *([1] * (x.dim() - keep.dim())))
    if x.dtype == torch.bool:
        return x & sel
    return torch.where(sel, bits(x), 0).view(x.dtype)


def _cat(xs, ys):
    return torch.cat([bits(xs), bits(ys)], dim=0).view(xs.dtype)


def tree_fold(
    states: Any,
    identity: Any,
    join: Callable[[Any, Any], Tuple[Any, torch.Tensor]],
) -> Tuple[Any, torch.Tensor]:
    """Fold ``states`` (batched on the leading axis) with
    ``join(a, b) -> (joined, flag)``; ``identity`` is one unbatched join
    identity. Returns ``(folded, any_flag)`` — flags are OR-accumulated
    across every pairwise join, reducing only the batch axis."""
    leaf = states
    while isinstance(leaf, tuple):
        leaf = leaf[0]
    r = leaf.shape[0]
    if r == 1:
        return join(tree_map(lambda x: x[0], states), identity)
    pow2 = 1
    while pow2 < r:
        pow2 *= 2
    if pow2 != r:
        pad = tree_map(
            lambda e: e.expand(pow2 - r, *e.shape), identity
        )
        states = tree_map(_cat, states, pad)
        r = pow2
    flagged = None
    while r > 1:
        half = r // 2
        left = tree_map(lambda x: x[:half], states)
        right = tree_map(lambda x: x[half:], states)
        states, flag = join(left, right)
        level = torch.any(flag, dim=0)
        flagged = level if flagged is None else flagged | level
        r = half
    return tree_map(lambda x: x[0], states), flagged
