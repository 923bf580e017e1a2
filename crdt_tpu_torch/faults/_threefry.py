"""The fault plan's random draws, bit for bit the JAX package's.

The JAX package draws each link's fates inside its traced program:
``uniform(fold_in(fold_in(PRNGKey(seed), uint32(r)), rank), (3,))`` for a
ring round (``faults/inject.py`` ``round_faults``) and
``uniform(fold_in(PRNGKey(seed), bix), (2,))`` for a stream block or a
bootstrap segment (``block_wire``). Those are threefry2x32 with 20
rounds over plain u32 words, so numpy reproduces them exactly:

- ``key(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]`` (``[0, seed]`` for
  a 32-bit seed);
- ``fold_in(k, d)`` is ``threefry(k, [0, d & 0xFFFFFFFF])``;
- the partitionable bits of draw ``i`` are ``out0 ^ out1`` of
  ``threefry(k, [0, i])`` (JAX's default ``jax_threefry_partitionable``);
- the float is ``float32((bits >> 9) | 0x3F800000) - 1``.

A rate compares in float32: JAX compares the float32 draw with a weakly
typed Python float, which becomes ``float32(rate)``, so a draw between
``float32(0.2)`` and ``0.2`` falls on the float32 side.

Every table is built on the host before a run and uploaded once
(:func:`fates`); no round of a ring reads the host.
"""

from __future__ import annotations

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on u32 arrays (broadcast together).
    Returns the two output words."""
    k0, k1, x0, x1 = (np.asarray(v, dtype=np.uint32) for v in (k0, k1, x0, x1))
    k0, k1, x0, x1 = np.broadcast_arrays(k0, k1, x0, x1)
    ks = (k0, k1, (k0 ^ k1 ^ np.uint32(0x1BD11BDA)).astype(np.uint32))
    with np.errstate(over="ignore"):
        x = [(x0 + ks[0]).astype(np.uint32), (x1 + ks[1]).astype(np.uint32)]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = (x[0] + x[1]).astype(np.uint32)
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = (x[0] + ks[(i + 1) % 3]).astype(np.uint32)
            x[1] = (x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return x[0], x[1]


def key(seed: int):
    """``jax.random.PRNGKey(seed)`` as its two u32 words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF)


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``; ``data`` may be an int array (each
    lane folds its own value into the same key)."""
    d = (np.asarray(data, dtype=np.int64) & 0xFFFFFFFF).astype(np.uint32)
    return threefry2x32(k[0], k[1], np.zeros_like(d), d)


def uniform(k, n: int) -> np.ndarray:
    """``jax.random.uniform(k, (n,))`` (float32 in [0, 1)); ``k`` may hold
    arrays of keys, the draws then stack on a last axis."""
    k0, k1 = (np.asarray(w, dtype=np.uint32)[..., None] for w in k)
    i = np.arange(n, dtype=np.uint32)
    y0, y1 = threefry2x32(k0, k1, np.zeros_like(i), i)
    word = ((y0 ^ y1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return word.view(np.float32) - np.float32(1.0)


def below(u: np.ndarray, rate: float) -> np.ndarray:
    """``u < rate`` as JAX compares it: in float32."""
    return u < np.float32(rate)


def round_draws(seed: int, rounds, ranks) -> np.ndarray:
    """The three ring draws of every ``(round, rank)``: float32
    ``[len(rounds), len(ranks), 3]``."""
    r = np.asarray(rounds, dtype=np.int64)[:, None]
    q = np.asarray(ranks, dtype=np.int64)[None, :]
    k = fold_in(fold_in(key(seed), r), np.broadcast_to(q, (r.shape[0], q.shape[1])))
    return uniform(k, 3)


def block_draws(seed: int, bix) -> np.ndarray:
    """The two block-wire draws of each block index: float32 ``[..., 2]``."""
    return uniform(fold_in(key(seed), bix), 2)


def fates(plan, rs, p: int, senders) -> np.ndarray:
    """The fate table of a ring: bool ``[len(rs), P, 3]`` holding
    ``(dropped, corrupted, delayed)`` of the inbound link of every rank
    at every round index in ``rs``, under the JAX priority rule (drop >
    corrupt > delay: one packet, one fate) and the ``dead`` rule (every
    packet from a dead sender drops; ``senders`` is ``sender_of``'s
    table). Evicted receivers are not masked here: that is the
    receive's step."""
    u = round_draws(plan.seed, rs, range(p))
    dropped = below(u[..., 0], plan.drop)
    if plan.dead:
        dead = np.isin(np.asarray(senders), np.asarray(plan.dead))
        dropped = dropped | dead[None, :]
    corrupted = below(u[..., 1], plan.corrupt) & ~dropped
    delayed = below(u[..., 2], plan.delay) & ~dropped & ~corrupted
    return np.stack([dropped, corrupted, delayed], axis=-1)


__all__ = ["below", "block_draws", "fates", "fold_in", "key", "round_draws", "threefry2x32",
           "uniform"]
