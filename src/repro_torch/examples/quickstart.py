"""Quickstart: the unified ``Comm`` API in 40 lines — the port of
``examples/quickstart.py``.

The paper fuses 2 MPI processes x 4 OpenMP threads into one communicator
of 8 unified ranks. Here the "processes" are 2 mesh rows and the
"threads" 4 mesh columns of ranks stacked on one device — and the
surface is one ``Comm`` object you derive sub-communicators from and
issue nonblocking requests on:

    root.split / root.dup / root.thread_comm / root.process_comm
    req = comm.iallreduce(x);  ... overlap ...  ;  req.wait()

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
          [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import threadcomm_init
from repro_torch.core.compat import make_mesh, rank_view
from repro_torch.examples import report, reset_counts

NT = 4  # threads per process (paper's #define NT 4)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the unified Comm API")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reset_counts()
    mesh = make_mesh((2, NT), ("proc", "thread"), device=args.device)
    dev = mesh.device

    # MPIX_Threadcomm_init(MPI_COMM_WORLD, NT, &threadcomm)
    root = threadcomm_init(mesh, process_axes=("proc",),
                           thread_axes=("thread",), num_threads=NT)
    n = root.size
    checks = {}
    with root.start():                     # MPIX_Threadcomm_start
        ranks = root.run(
            lambda x: x + rank_view(root.device_rank(), x).to(x.dtype),
            torch.zeros(n, device=dev))
        for r in ranks.cpu().to(torch.int64).tolist():
            print(f" Rank {r} / {n}")
        checks["ranks"] = ranks.cpu().tolist() == list(range(n))

        # derive sub-communicators: the fast (intra-process) domain via
        # split — color = process index — and the slow domain for free
        tcomm = root.split([r // NT for r in range(n)])
        pcomm = root.process_comm()
        print(f" split -> {tcomm.size}-rank thread comms "
              f"x{len(tcomm.families())}, {pcomm.size}-rank process comms")
        print(f" rank 2 of process-1's thread comm is unified rank "
              f"{tcomm.translate(2, family=1)}")
        checks["translate"] = tcomm.translate(2, family=1) == NT + 2

        # nonblocking allreduce: a Request you overlap compute with
        def overlapped(v):
            with root.stream("grad"):
                req = root.iallreduce(v)   # issued on the "grad" stream
            local = v * 2.0                # overlaps the collective
            return req.wait() + 0.0 * local
        total = root.run(overlapped, torch.arange(float(n), device=dev))
        print(f" iallreduce over {n} unified ranks:", float(total[0]),
              "(expected", sum(range(n)), ")")
        checks["iallreduce"] = float(total[0]) == sum(range(n))

        # the two-level hierarchical schedule IS a sub-comm composition:
        # thread.reduce_scatter -> process.allreduce -> thread.allgather
        h = root.run(lambda v: root.allreduce(v, schedule="hierarchical"),
                     torch.arange(float(n), device=dev))
        print(" hierarchical (sub-comm composed) allreduce:", float(h[0]))
        checks["hierarchical"] = float(h[0]) == sum(range(n))
        # a message-round schedule: one launch of a round program
        rd = root.run(lambda v: root.allreduce(
            v, schedule="recursive_doubling"),
            torch.arange(float(n), device=dev))
        print(" recursive-doubling allreduce:", float(rd[0]))
        checks["recursive_doubling"] = float(rd[0]) == sum(range(n))
    # MPIX_Threadcomm_finish at context exit — every derived comm/request
    # above is now invalid (activation-window rule, paper §2)
    root.free()                            # MPIX_Threadcomm_free
    print("done.")
    return report("quickstart", checks)


if __name__ == "__main__":
    main()
