"""``prefill_chunk_ms`` (layer ``serve/engine.py``, the fused chunk
batch): the median device time of the program tracer's ``prefill_chunk``
spans in the window before the profiled slice. A span's ``device_ms`` is
the time between two CUDA events the tracer records on the engine's
stream, one as the step's chunk batch starts packing, one after its
first tokens are read back: the batch's whole device work. None where no
span carries it (a CPU run, or a program without device-timed spans)."""


def read(run):
    ms = [args["device_ms"] for name, t0, t1, args in run.spans
          if name == "prefill_chunk" and "device_ms" in args
          and 0 <= t0 and t1 <= run.slice_at]
    return run.stats.percentile(ms, 50)
