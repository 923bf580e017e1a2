"""Register models of the port. Only the overflow exception is here so
far: ``BatchedMap`` raises it when a key's sibling slab is full. The
batched register models themselves (``BatchedMVReg``, ``BatchedLWWReg``
in the JAX package's ``models/registers.py``) are not ported yet."""


class SlotOverflow(RuntimeError):
    """A sibling could not be held: the slot buffer exceeded its static
    capacity. Raise rather than silently dropping concurrent writes —
    rebuild the model with a larger ``n_slots``."""
