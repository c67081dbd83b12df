"""Collectives through the unified ``Comm`` API: the paper's §4.2
comparisons plus the split/dup + nonblocking surface — the port of
``examples/collectives_demo.py``.

Shows: derived sub-communicators (split by color, dup), collectives as
comm METHODS (dissemination vs atomic barrier, binomial reduce/bcast,
ring / recursive-doubling allreduce), the hierarchical allreduce as an
explicit sub-comm composition (thread.reduce -> process.allreduce ->
thread.bcast), and request-based nonblocking overlap on a CommStream
(a CUDA stream on the card).

Run:  PYTHONPATH=src python -m repro_torch.examples.collectives_demo
          [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import threadcomm_init
from repro_torch.core.compat import make_mesh
from repro_torch.examples import report, reset_counts


def main(argv=None):
    ap = argparse.ArgumentParser(description="collectives as comm methods")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reset_counts()
    mesh = make_mesh((2, 4), ("proc", "thread"), device=args.device)
    root = threadcomm_init(mesh, process_axes=("proc",),
                           thread_axes=("thread",))
    n = root.size
    x = torch.arange(float(n), device=mesh.device) + 1.0
    flat = n * (n + 1) // 2
    checks = {}

    with root.start():
        print(f"== comm: {root.num_processes} processes x "
              f"{root.threads_per_process} threads = {n} unified ranks ==")

        # ---- collectives are methods on the comm ----
        for mode in ("msg", "atomic"):
            tok = root.run(lambda v, m=mode: root.barrier(
                v[:, 0], mode=m)[:, None], x)
            print(f"barrier[{mode:6s}]  -> token {float(tok[0]):.0f} "
                  f"(max over ranks = {n})")
            checks[f"barrier_{mode}"] = float(tok[0]) == n

        r = root.run(lambda v: root.reduce(v, root=0, schedule="binomial"),
                     x)
        print(f"reduce(binomial) -> root holds {float(r[0]):.0f} "
              f"(sum = {flat})")
        checks["reduce"] = float(r[0]) == flat

        b = root.run(lambda v: root.bcast(v, root=5), x)
        print(f"bcast(root=5)    -> all ranks hold {set(b.cpu().tolist())}")
        checks["bcast"] = set(b.cpu().tolist()) == {6.0}

        for sched in ("psum", "ring", "recursive_doubling",
                      "hierarchical", "hierarchical_tree"):
            out = root.run(lambda v, s=sched: root.allreduce(v, schedule=s),
                           x)
            ok = bool(torch.allclose(out.cpu(), torch.full((n,),
                                                           float(flat))))
            print(f"allreduce[{sched:18s}] -> {'OK' if ok else 'MISMATCH'}")
            checks[f"allreduce_{sched}"] = ok

        # ---- derived sub-comms are load-bearing ----
        # split by process color: per-process thread comms (fast domain)
        tcomm = root.split([rr // 4 for rr in range(n)])
        pcomm = root.process_comm()
        per_proc = root.run(lambda v: tcomm.allreduce(v), x)
        sums = sorted(set(per_proc.cpu().tolist()))
        print("split(thread).allreduce -> per-process sums", sums)
        checks["split_allreduce"] = sums == [10.0, 26.0]
        # the hierarchical schedule, spelled out as the composition
        comp = root.run(
            lambda v: tcomm.bcast(pcomm.allreduce(
                tcomm.reduce(v, root=0)), root=0), x)
        print("thread.reduce -> process.allreduce -> thread.bcast:",
              float(comp[0]), f"(= flat {flat})")
        checks["composition"] = float(comp[0]) == flat
        # a non-grid split still works (generic merged-ring path)
        parity = root.split([rr % 2 for rr in range(n)])
        pp = root.run(lambda v: parity.allreduce(v), x)
        odd_even = sorted(set(pp.cpu().tolist()))
        print("split(parity).allreduce ->", odd_even, "(odd/even rank sums)")
        checks["parity_split"] = odd_even == [16.0, 20.0]

        # ---- nonblocking requests on a stream ----
        def overlapped(v):
            with root.stream("s0"):
                r1 = tcomm.iallreduce(v)       # fast domain, in flight
                r2 = pcomm.iallreduce(r1.wait())   # slow domain, ordered
            return r2.wait()
        nb = root.run(overlapped, x)
        print("stream-ordered iallreduce pipeline ->", float(nb[0]),
              f"(= flat {flat})")
        checks["stream_pipeline"] = float(nb[0]) == flat

        # one unified barrier spans processes AND threads (the paper's
        # point: MPI+Threads needs omp-barrier + MPI_Barrier + omp-barrier)
        root.run(lambda v: root.barrier(v[:, 0], mode="msg")[:, None], x)
        print("single unified barrier across processes AND threads: OK")
    root.free()
    return report("collectives_demo", checks)


if __name__ == "__main__":
    main()
