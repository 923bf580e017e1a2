"""The JAX package's seven runnable tours, written against the port's
public surface.

Each module runs one tour of ``examples/`` on ``device=`` (``"cuda"``
unless the caller asks for the CPU): it prints the lines the JAX tour
prints, in the same order, keeps every assertion of the tour, and
returns from ``main(device)`` a dict of the values those lines carry.
Importing a module runs nothing. Run one from the repository root::

    python -m crdt_tpu_torch.examples.ex01_collaborative_tags             # on the card
    python -m crdt_tpu_torch.examples.ex01_collaborative_tags --device cpu

Without ``--device`` a tour needs a CUDA device and exits with a message
when there is none; it never falls back to the CPU. The two ``mesh:``
lines (ex02, ex05) name the port's virtual ranks where the JAX tours
name host devices; their shape dict is the JAX mesh's.
"""

#: Each port module beside the JAX tour it follows line for line.
EXAMPLES = (
    ("ex01_collaborative_tags", "examples/01_collaborative_tags.py"),
    ("ex02_mesh_anti_entropy", "examples/02_mesh_anti_entropy.py"),
    ("ex03_streamed_editing", "examples/03_streamed_editing.py"),
    ("ex04_multihost", "examples/04_multihost_dcn.py"),
    ("ex05_delta_sync", "examples/05_delta_sync.py"),
    ("ex06_deep_nesting_and_sparse", "examples/06_deep_nesting_and_sparse.py"),
    ("ex07_lifecycle_and_certificates", "examples/07_lifecycle_and_certificates.py"),
)

__all__ = ["EXAMPLES"]
