"""MPIX Threadcomm on one card — back-compat facade.

The communicator lives in :mod:`repro_torch.core.comm`; this module keeps
the reference's original import surface::

    from repro_torch.core.threadcomm import ThreadComm, threadcomm_init

Lifecycle (paper §2):

    tc = threadcomm_init(mesh, process_axes, thread_axes)   # heavy, collective
    with tc.start():                                        # light, activates
        tc.run(fn, ...)                                     # unified-rank comm
    # finish() implicit at context exit — derived objects invalidated
    tc.free()                                               # releases the comm
"""

from repro_torch.core.comm import (AxisComm, Comm, CommError, CommStream,  # noqa: F401
                                   Group, GroupComm, Request, ThreadComm,
                                   ThreadCommError, threadcomm_init, testall,
                                   waitall)
