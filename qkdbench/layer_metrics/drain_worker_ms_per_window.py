"""Wall milliseconds a window that the drain workers spend inside
``drain.materialize`` (on threads other than the loop's), per window Bob
finalized while traced.  The time includes the workers' waits on the
interpreter lock, so it is not the drain's busy time: a change that only
shortens those waits lowers it too."""

from qkdbench import program_spans


def read(record):
    spans = program_spans.read(record)
    if spans is None:
        return None
    return program_spans.per_window_ms(
        spans, sum(spans.clipped(sp)
                   for sp in spans.named("drain.materialize", "other")))
