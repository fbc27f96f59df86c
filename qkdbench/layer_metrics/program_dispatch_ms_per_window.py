"""Host milliseconds a window in the window programs' calls (the
``program.*`` spans: Alice's, Bob's, the retries', PA and pack), per
window Bob finalized while traced: what dispatching a window's launches
costs the host."""

from qkdbench import program_spans


def read(record):
    spans = program_spans.read(record)
    if spans is None:
        return None
    return program_spans.per_window_ms(
        spans, sum(spans.clipped(sp) for sp in spans.spans
                   if sp.name.startswith("program.")))
