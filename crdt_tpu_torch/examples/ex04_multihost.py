"""Multi-process anti-entropy: two processes join one process group
(gloo, ``parallel.multihost``), build a global (replica × element) mesh
with the replica axis spanning processes — the DCN-facing axis — and run
the SAME ``mesh_fold`` on each. The only cross-process traffic is the
replica-axis lattice-join all-reduce. Then each process serves its own
tenant shard on a local mesh and one ``sync_tenant_shards`` round hands
a stale row off (the port of ``examples/04_multihost_dcn.py``).

Both workers run on ``device`` — on one card they share it, each with 4
local virtual ranks.

Run (spawns its own two worker processes):
  python -m crdt_tpu_torch.examples.ex04_multihost [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from crdt_tpu_torch.examples._tour import cli

#: Seconds both workers may take together (one deadline shared by both waits).
DEADLINE = 120
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _say(line: str) -> None:
    """Print one line in one write: the two workers share the parent's
    standard output, and ``print`` may write a line and its newline
    apart, which lets the peer's line land between them."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def worker(port: int, pid: int, device="cuda") -> dict:
    """One process of the tour: joins the group at ``localhost:port`` as
    process ``pid`` of 2, prints its two lines and returns what they
    carry."""
    from crdt_tpu_torch.faults import RetryPolicy
    from crdt_tpu_torch.ops.orswot import OrswotState
    from crdt_tpu_torch.parallel import VirtualMesh, mesh_fold, multihost
    from crdt_tpu_torch.serve import IngestQueue, Superblock, TenantShardMap, sync_tenant_shards

    multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)

    # Eight replicas; each process owns rows [pid*4, (pid+1)*4). Every
    # replica adds members under its own actor lane.
    R, E, A = 8, 64, 8
    rng = np.random.default_rng(7)
    ctr = np.zeros((R, E, A), np.uint32)
    for i in range(R):
        mine = rng.random(E) < 0.4
        ctr[i, mine, i] = 1
    top = ctr.max(axis=1)

    mesh = multihost.global_mesh(n_element_shards=2, local_ranks=4, device=device)
    rows = slice(pid * 4, (pid + 1) * 4)
    local = OrswotState(
        top=top[rows],
        ctr=ctr[rows],
        dcl=np.zeros((4, 2, A), np.uint32),
        dmask=np.zeros((4, 2, E), bool),
        dvalid=np.zeros((4, 2), bool),
    )
    gstate = multihost.host_to_global(local, mesh)

    joined, overflow = mesh_fold(gstate, mesh)
    result = multihost.global_to_host(joined)
    assert not bool(overflow)

    members = int((np.asarray(result.ctr) > 0).any(-1).sum())
    union = int((ctr > 0).any((0, 2)).sum())
    assert members == union
    _say(f"process {pid}: converged set has {members}/{union} members")

    # ---- per-host tenant shards + DCN anti-entropy (serve/) -------------
    # Each host serves ITS OWN tenant shard on a LOCAL mesh (tenants are
    # independent — only handoff rows ever cross processes, and they ride
    # sync_tenant_rows under retry=). Host 0 also holds a stale row for a
    # tenant host 1 owns (pre-failover residency); one sync round hands it
    # off and both hosts' reads converge to the lattice join.
    lmesh = VirtualMesh(4, device)
    caps = dict(n_elems=8, n_actors=2, deferred_cap=2)
    sb = Superblock(8, lmesh, kind="orswot", caps=caps)
    smap = TenantShardMap(2)
    q = IngestQueue(sb, lanes=4, depth=2)

    def mask(*on):
        return np.isin(np.arange(8), on)

    for t in smap.owned(pid, range(8)):
        q.add(t, pid, 1, mask(t % 8))
    foreign = next(t for t in range(8) if smap.owner(t) != pid)
    q.add(foreign, pid, 1, mask(7 - (foreign % 8)))  # stale foreign residue
    q.drain()

    rep = sync_tenant_shards(
        sb, smap, pid, handoff=[foreign], retry=RetryPolicy(attempts=3),
    )
    # The peer's foreign tenant is owned by THIS host (two hosts: not-peer
    # == me), so each host joins exactly one handed-off row, and its read
    # is the lattice join of both contributions.
    peer_foreign = next(t for t in range(8) if smap.owner(t) != 1 - pid)
    assert rep.tenants_shipped == 1 and rep.tenants_joined == 1, rep
    want_members = {peer_foreign % 8, 7 - (peer_foreign % 8)}
    got_members = set(int(m) for m in np.where(np.asarray(sb.read(peer_foreign)))[0])
    assert got_members == want_members, (got_members, want_members)
    owned = len(smap.owned(pid, range(8)))
    _say(
        f"process {pid}: shard owns {owned} "
        f"tenants, handed off {rep.tenants_shipped}, joined "
        f"{rep.tenants_joined} over DCN; handoff read converged"
    )
    return {"process": pid, "members": members, "union": union, "owned": owned,
            "shipped": rep.tenants_shipped, "joined": rep.tenants_joined,
            "handoff_tenant": peer_foreign, "handoff_members": sorted(got_members)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_command(port: int, pid: int, device, out: str) -> list:
    """The command line of one worker: this module with ``--worker``."""
    return [sys.executable, "-m", "crdt_tpu_torch.examples.ex04_multihost", "--worker",
            str(port), str(pid), "--device", str(device), "--out", out]


def main(device="cuda", command=worker_command) -> dict:
    """Spawn the two workers (``command(port, pid, device, out)`` gives
    each one's command line; it writes its result to ``out``), wait for
    both under one deadline, and kill a worker that outlives it or its
    peer."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + env.get("PYTHONPATH", "").split(os.pathsep)).rstrip(os.pathsep)
    with tempfile.TemporaryDirectory() as root:
        outs = [os.path.join(root, f"worker{pid}.json") for pid in (0, 1)]
        procs = [subprocess.Popen(command(port, pid, device, outs[pid]), env=env)
                 for pid in (0, 1)]
        deadline = time.monotonic() + DEADLINE  # shared budget across BOTH waits
        rcs = None
        try:
            rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        finally:
            # One worker dying can leave its peer blocked in the rendezvous
            # or all-reduce — never orphan it, on any exit path.
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert rcs == [0, 0], f"worker exit codes {rcs}"
        workers = []
        for path in outs:
            with open(path) as f:
                workers.append(json.load(f))
    print("both processes agree: multi-host fold over DCN converged")
    return {"workers": workers, "agree": True}


def _worker_main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", nargs=2, type=int, metavar=("PORT", "PID"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    res = worker(*args.worker, device=args.device)
    with open(args.out, "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv[1:]:
        sys.exit(_worker_main(sys.argv[1:]))
    sys.exit(cli(main, __doc__))
