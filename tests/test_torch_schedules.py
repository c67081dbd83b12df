"""Port schedules and protocol model vs the JAX reference.

``repro_torch.core.schedules`` is a copy of the reference's pure rank
arithmetic and ``repro_torch.core.protocol`` extends its copy of the
protocol model; ``repro_torch.kernels.msgq.ops.copy_accounting`` is a copy
of the reference's byte accounting. Each is held equal to its twin (exact:
the same float arithmetic in the same order) for every rank count from 1
to 33 and at bench_p2p's message sizes plus the protocol thresholds'
edges. The device half of the protocol model has no twin to compare: it
is checked against its own formulas.
"""

import math

import pytest

from repro.core import protocol as jproto
from repro.core import schedules as jsch
from repro.kernels.msgq.ops import copy_accounting as jaccounting
from repro_torch.core import protocol as tproto
from repro_torch.core import schedules as tsch
from repro_torch.kernels.msgq.ops import copy_accounting as taccounting

SIZES = [0, 1, 63, 64, 256, 1024, 2048, 4095, 4096, 4097, 16384, 16385,
         65536, 1 << 20, 1 << 22]
ALPHA_BETA = dict(alpha=2e-6, beta=1e-9)


@pytest.mark.parametrize("n", range(1, 34))
def test_schedules_match_reference(n):
    assert tsch._ceil_log2(n) == jsch._ceil_log2(n)
    assert tsch.dissemination_rounds(n) == jsch.dissemination_rounds(n)
    assert tsch.ring_rounds(n) == jsch.ring_rounds(n)
    for root in range(n):
        assert (tsch.binomial_reduce_rounds(n, root)
                == jsch.binomial_reduce_rounds(n, root))
        assert (tsch.binomial_bcast_rounds(n, root)
                == jsch.binomial_bcast_rounds(n, root))
    if n & (n - 1) == 0:
        assert (tsch.recursive_doubling_rounds(n)
                == jsch.recursive_doubling_rounds(n))
    else:
        with pytest.raises(AssertionError):
            tsch.recursive_doubling_rounds(n)
    for rounds in (tsch.dissemination_rounds(n),
                   tsch.binomial_reduce_rounds(n, n // 2)):
        assert (tsch.simulate_knowledge(n, rounds)
                == jsch.simulate_knowledge(n, rounds))
        values = [float(3 * i + 1) for i in range(n)]
        assert (tsch.simulate_reduce(n, rounds, values)
                == jsch.simulate_reduce(n, rounds, values))
    for m in (1, 2, 4):
        assert (tsch.two_level_allreduce_plan(n, m)
                == jsch.two_level_allreduce_plan(n, m))
    for nbytes in (64, 4096, 1 << 20):
        for schedule in ("ring", "recursive_doubling", "reduce_bcast"):
            assert (tsch.allreduce_cost(n, nbytes, schedule=schedule,
                                        **ALPHA_BETA)
                    == jsch.allreduce_cost(n, nbytes, schedule=schedule,
                                           **ALPHA_BETA))
        kw = dict(alpha_fast=1e-7, beta_fast=1e-11, alpha_slow=2e-6,
                  beta_slow=1e-9)
        assert (tsch.hierarchical_allreduce_cost(n, 4, nbytes, **kw)
                == jsch.hierarchical_allreduce_cost(n, 4, nbytes, **kw))
        assert (tsch.flat_allreduce_cost(n, nbytes, alpha_slow=2e-6,
                                         beta_slow=1e-9)
                == jsch.flat_allreduce_cost(n, nbytes, alpha_slow=2e-6,
                                            beta_slow=1e-9))


@pytest.mark.parametrize("nbytes", SIZES)
def test_protocol_model_matches_reference(nbytes):
    for interthread in (True, False):
        for cell in (256, 2048, 4096):
            assert (tproto.select_protocol(nbytes, interthread, cell)
                    == jproto.select_protocol(nbytes, interthread, cell))
    host_t, host_j = tproto.HostModel(), jproto.HostModel()
    assert (tproto.interthread_latency(nbytes, host_t)
            == jproto.interthread_latency(nbytes, host_j))
    for proto in tproto.PROTOCOLS:
        assert (tproto.interthread_latency(nbytes, host_t, proto)
                == jproto.interthread_latency(nbytes, host_j, proto))
        assert (tproto.request_overhead(nbytes, proto)
                == jproto.request_overhead(nbytes, proto))
        assert (taccounting(nbytes, proto) == jaccounting(nbytes, proto))
        assert (taccounting(nbytes, proto, 2048)
                == jaccounting(nbytes, proto, 2048))
    assert (tproto.request_overhead(nbytes)
            == jproto.request_overhead(nbytes))
    assert (tproto.interprocess_latency(nbytes)
            == jproto.interprocess_latency(nbytes))
    assert (tproto.chunked_handoff_latency(nbytes, 1024)
            == jproto.chunked_handoff_latency(nbytes, 1024))
    assert (tproto.paged_admission_latency(nbytes, 1024, 512)
            == jproto.paged_admission_latency(nbytes, 1024, 512))
    if nbytes:
        t = tproto.interthread_latency(nbytes)
        assert tproto.bandwidth(nbytes, t) == jproto.bandwidth(nbytes, t)


def test_protocol_names_and_thresholds_match_reference():
    assert tproto.PROTOCOLS == jproto.PROTOCOLS
    assert (tproto.EAGER_THRESHOLD_INTERTHREAD,
            tproto.EAGER_THRESHOLD_INTERPROCESS, tproto.DEFAULT_CELL_SIZE) \
        == (jproto.EAGER_THRESHOLD_INTERTHREAD,
            jproto.EAGER_THRESHOLD_INTERPROCESS, jproto.DEFAULT_CELL_SIZE)
    with pytest.raises(ValueError, match="unknown protocol"):
        tproto.validate_protocol("rendezvous")
    with pytest.raises(ValueError, match="unknown protocol"):
        tproto.request_overhead(64, "bogus")


@pytest.mark.parametrize("nbytes", [64, 4096, 65536, 1 << 22])
def test_device_model(nbytes):
    """The card's model: one issue per round, every byte read and written
    once in device memory; the eager copy adds a pass through shared
    memory and back."""
    m = tproto.DeviceModel()
    assert m.t_issue > 0 and math.isfinite(m.t_issue)
    assert m.bw_hbm == 3.35e12 and m.cell == tproto.DEFAULT_CELL_SIZE
    direct = tproto.direct_copy_time(nbytes, m)
    assert direct == m.t_issue + 2 * nbytes / m.bw_hbm
    assert (tproto.staged_copy_time(nbytes, m)
            == direct + 2 * nbytes / m.bw_smem)
