"""Bob's sifting's share of its roofline, in percent: the summed least
time of the traced sift calls (``sift_bound``: their events' bytes and
the sifted outputs at the card's bandwidth) over the device time of
every kernel launched inside the benchmark's ``sift`` spans.  None where
the run traced no sift call or no such kernel."""

from qkdbench.sift_bound import sift_bound_s


def read(record):
    trace, calls = record.get("trace"), record.get("sift_batches")
    if trace is None or not calls:
        return None
    device_s = sum(e - s for _, s, e, _ in trace.launched_in("sift")) / 1e6
    if device_s <= 0:
        return None
    return 100.0 * sum(sift_bound_s(*c) for c in calls) / device_s
