"""The profiled slice's idle stretches split by what the host was doing
(shared by ``idle_in_forward.saturated`` and ``idle_in_engine.saturated``;
not a metric itself). An idle stretch is time in the slice with no
device operation running (the union ``bench.readers.idle_share``
takes); it falls in the model's forward where a program's
``prefill_chunk.forward`` / ``decode.forward`` range (the tracer's spans,
mirrored into the profiler) covers it, in the engine's own Python where
the harness's ``engine.step`` range covers it and no forward does, else
in the harness between steps."""

FORWARD = ("prefill_chunk.forward", "decode.forward")
ENGINE = "engine.step"


def union(ranges):
    """Sorted, disjoint (start, end) pairs covering ``ranges``."""
    out = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(r) for r in out]


def meet(xs, ys):
    """The intersection of two sorted, disjoint range lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(ranges) -> float:
    return sum(b - a for a, b in ranges)


def idle(reading):
    """The slice's stretches in [0, window_s] with no device operation."""
    busy = union((s, s + d) for _, s, d in reading.device)
    out, t = [], 0.0
    for a, b in busy:
        if a > t:
            out.append((t, min(a, reading.window_s)))
        t = max(t, b)
    if t < reading.window_s:
        out.append((t, reading.window_s))
    return [(a, b) for a, b in out if a < b]


def split(run):
    """(per cent of the slice idle inside a forward, idle in the engine
    outside any forward), or None where the slice has no device operation
    or no forward range (a program that does not mirror its spans)."""
    r = run.reading
    if r is None or not r.device or r.window_s <= 0:
        return None
    fwd = union((s, e) for n, s, e in r.host if n in FORWARD)
    if not fwd:
        return None
    eng = union((s, e) for n, s, e in r.host if n == ENGINE)
    gaps = idle(r)
    in_fwd = length(meet(gaps, fwd))
    in_eng = length(meet(gaps, eng)) - length(meet(meet(gaps, eng), fwd))
    return 100.0 * in_fwd / r.window_s, 100.0 * in_eng / r.window_s
