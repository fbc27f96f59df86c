"""Percent of the traced window in which nothing ran on the card while
the loop's thread was inside the program's drain (``drain`` spans,
mapped onto the trace's clock)."""

from qkdbench import program_spans


def read(record):
    spans = program_spans.read(record)
    if spans is None or spans.t1 <= spans.t0:
        return None
    idle = spans.idle_us(spans.named("drain", "main"),
                         program_spans.busy_intervals(record["trace"]))
    return 100.0 * idle / (spans.t1 - spans.t0)
