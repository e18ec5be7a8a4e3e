"""Device ms per stabilized frame of the host-to-device and
device-to-host copies (the upload ring, the side stream's fetch)."""

MERGE = "max"


def _copy(name, kind, link):
    return kind == "gpu_memcpy" and ("HtoD" in name or "DtoH" in name)


def read(run):
    if run.trace is None or not run.work.get("frames"):
        return None
    return 1e3 * run.trace.sum_s(_copy) / run.work["frames"]
