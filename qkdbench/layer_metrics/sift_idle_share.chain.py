"""Percent of the traced window in which nothing ran on the card while
the loop's thread was inside the chain's framing, sifting or splice (its
outermost ``chain.*``, ``sift.*`` and ``alice.splice`` spans, mapped onto
the trace's clock)."""

from qkdbench import chain_spans, program_spans


def read(record):
    found = chain_spans.outermost(record)
    if found is None:
        return None
    spans, outer = found
    if spans.t1 <= spans.t0:
        return None
    idle = spans.idle_us(outer, program_spans.busy_intervals(
        record["trace"]))
    return 100.0 * idle / (spans.t1 - spans.t0)
