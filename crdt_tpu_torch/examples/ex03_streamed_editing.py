"""Live collaborative editing at device scale: a streamed edit trace
(config-5 shape) ingested burst by burst — the native C++ engine mints
identifiers, replicas apply on device as scatter epochs — with a
checkpoint/resume in the middle (the port of
``examples/03_streamed_editing.py``).

Run:  python -m crdt_tpu_torch.examples.ex03_streamed_editing [--device cpu]
"""

from __future__ import annotations

import os
import random
import sys
import tempfile

from crdt_tpu_torch.checkpoint import load, save
from crdt_tpu_torch.examples._tour import cli
from crdt_tpu_torch.models import BatchedList
from crdt_tpu_torch.native import DELETE, INSERT
from crdt_tpu_torch.pure.list import List


def burst(rng, length, n_ops):
    kinds, idxs, vals, actors = [], [], [], []
    for _ in range(n_ops):
        if length == 0 or rng.random() < 0.7:
            kinds.append(INSERT)
            idxs.append(rng.randrange(length + 1))
            length += 1
        else:
            kinds.append(DELETE)
            idxs.append(rng.randrange(length))
            length -= 1
        vals.append(rng.randrange(32, 127))
        actors.append(rng.randrange(4))
    return (kinds, idxs, vals, actors), length


def main(device="cuda") -> dict:
    rng = random.Random(7)
    model = BatchedList(8, device=device)  # 8 device replicas over one shared universe
    oracle = List()
    length = 0
    bursts = []

    for i in range(3):
        ops, length = burst(rng, length, 40)
        model.extend_trace(*ops)      # universe grows; slots re-permute
        model.apply_trace_to_all(chunk=16)
        for k, ix, v, a in zip(*ops):
            op = (oracle.insert_index(ix, v, a) if k == INSERT
                  else oracle.delete_index(ix, a))
            oracle.apply(op)
        assert model.read(0) == oracle.read()
        print(f"burst {i}: {len(ops[0])} ops, sequence length {len(oracle.read())}")
        bursts.append((len(ops[0]), len(oracle.read())))

        if i == 1:  # checkpoint mid-stream, resume, keep streaming
            with tempfile.TemporaryDirectory() as d:
                p = os.path.join(d, "list.npz")
                save(p, model)
                model = load(p, device=device)
            print("  checkpointed and resumed mid-stream")

    text = "".join(chr(v) for v in model.read(0))
    print(f"final document ({len(text)} chars): {text[:60]!r}...")
    return {"bursts": bursts, "text": text}


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
