"""Device kernels, copies and memsets in the traced window, per window
Bob finalized while it was traced."""


def read(record):
    trace, windows = record.get("trace"), record.get("trace_windows")
    if trace is None or not windows:
        return None
    return trace.launches() / windows
