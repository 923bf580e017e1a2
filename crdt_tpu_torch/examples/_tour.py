"""What the tours share: the command line and bit-exact leaf equality."""

from __future__ import annotations

import argparse
import sys

import torch

from .._dtypes import bits

#: The virtual ranks of the mesh tours: the JAX tours' 8 forced host devices.
VIRTUAL_RANKS = 8


def same(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Two leaves equal bit for bit, dtype and shape included (the port's
    ``np.testing.assert_array_equal``)."""
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))


def cli(main, doc: str) -> int:
    """``python -m crdt_tpu_torch.examples.<tour> [--device DEVICE]``: run
    ``main(device)`` on the card unless ``--device`` names another; with
    no card and no ``--device`` it exits 2 with a message."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("this tour runs on a CUDA device and none is present; pass --device cpu to run it "
              "on the CPU", file=sys.stderr)
        return 2
    main(args.device)
    return 0
