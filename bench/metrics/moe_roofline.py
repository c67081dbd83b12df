"""``moe_roofline`` (layer ``models/moe.py``): the MoE block's prompt-chunk
calls in the window before the profiled slice against their roofline.
Each ``moe`` span of phase ``chunk`` is one layer's call on the chunk
batch of its step, whose ``prefill_chunk`` span gives the batch's valid
tokens V. The call needs, in bf16: the router and the top-k experts of
V tokens (``bench.work``'s terms); the weights of min(E, V top_k)
experts read once, the router's, and V x d in and out. Its least time is
max(FLOPs / bf16 peak, bytes / HBM bandwidth); the metric is the sum of
the least times over the sum of the spans' ``device_ms``.

Device-timed chunk spans with no device-timed ``moe`` span fail the run:
a renamed or lost span must not read nothing. A CPU run (no device
time) or a program without the spans reads nothing."""

ACT_BYTES = 2       # bf16


def call_cost(c: dict, v: int):
    """(FLOPs, bytes) one layer's MoE call on ``v`` valid tokens needs."""
    d, f, e, k = c["d_model"], c["d_ff"], c["num_experts"], c["top_k"]
    gates = 2 if c.get("mlp_act", "swiglu") in ("swiglu", "geglu") else 1
    flops = v * (2 * d * e + k * 2 * (gates + 1) * d * f)
    weights = min(e, v * k) * (gates + 1) * d * f + d * e
    return flops, ACT_BYTES * (weights + 2 * v * d)


def read(run):
    if run.c.get("block") != "moe":
        return None
    before = [(name, args) for name, t0, t1, args in run.spans
              if 0 <= t0 and t1 <= run.slice_at]
    chunks = {a["step"]: a for n, a in before
              if n == "prefill_chunk" and "tokens" in a}
    calls = [a for n, a in before if n == "moe" and "device_ms" in a
             and a.get("phase") == "chunk" and a.get("step") in chunks]
    if not calls:
        if any("device_ms" in a for a in chunks.values()):
            raise RuntimeError(
                f"{len(chunks)} device-timed prefill_chunk spans before the "
                "slice, but no device-timed moe span of phase chunk")
        return None
    least = dev = 0.0
    for a in calls:
        flops, byt = call_cost(run.c, chunks[a["step"]]["tokens"])
        least += max(flops / run.hw.BF16_FLOPS, byt / run.hw.HBM_BYTES_S)
        dev += 1e-3 * a["device_ms"]
    return 100.0 * least / dev if dev > 0 else None
