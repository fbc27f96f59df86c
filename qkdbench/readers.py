"""Arithmetic the per-layer metric readers share (each metric is its own
file under ``layer_metrics/``, holding ``read(record)``).  A reader
returns None where the record holds nothing to read, and never 0 for a
share of a roofline."""

from __future__ import annotations

from qkdbench.roofline import decode_bound_s, toeplitz_bound_s

__all__ = ["bp_layered_roofline", "idle_share", "pa_roofline"]


def _is_layered(name: str) -> bool:
    return "bp_layered" in name


def bp_layered_roofline(record):
    """Percent: the least time of a traced layered decode (each from its
    shapes and the iterations it returned), averaged over the recorded
    decodes, over the layered kernel's mean device time in the trace.  With
    one kernel a decode this is the summed bound over the summed time; the
    profiler can miss a kernel launched just after it starts, so up to 1%
    of the decodes (at least one) may lack theirs; beyond that, None."""
    trace, calls = record.get("trace"), record.get("decodes")
    if trace is None or not calls:
        return None
    kernels = trace.kernel_count(_is_layered)
    if not kernels or abs(kernels - len(calls)) > max(1, len(calls) // 100):
        return None
    device_s = trace.kernel_s(_is_layered) / kernels
    if device_s <= 0:
        return None
    return 100.0 * sum(decode_bound_s(*c) for c in calls) / len(calls) \
        / device_s


def pa_roofline(record):
    """Percent: the summed least time of the traced PA hashes over the
    device time of every kernel launched inside a ``pa`` span."""
    trace, calls = record.get("trace"), record.get("pas")
    if trace is None or not calls:
        return None
    kernels = trace.launched_in("pa")
    device_s = sum(e - s for _, s, e, _ in kernels) / 1e6
    if device_s <= 0:
        return None
    return 100.0 * sum(toeplitz_bound_s(B, n, m) for B, n, m in calls) \
        / device_s


def idle_share(record):
    """Percent of the traced window in which nothing ran on the card."""
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
