"""``queue_wait_p95_ms`` (layer ``serve/scheduler.py``): the 95th
percentile, over every request due in the window before the profiled
slice, of the time from when it fell due to the scheduler's ``admit``
instant (the program's tracer). A request not admitted by the window's
end counts up to the end."""


def read(run):
    admitted = {}
    for name, t0, _, args in run.spans:
        rid = args.get("rid")
        if name == "admit" and t0 >= 0 and rid in run.dues:
            admitted.setdefault(rid, t0)
    dues = {rid: d for rid, d in run.dues.items() if d < run.slice_at}
    if not dues or not admitted:
        return None
    waits = [admitted.get(rid, run.window_s) - due
             for rid, due in dues.items()]
    return 1e3 * run.stats.percentile(waits, 95)
