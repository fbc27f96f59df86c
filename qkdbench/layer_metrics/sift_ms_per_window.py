"""Host milliseconds a window in the chain's framing, sifting and splice:
the loop thread's outermost ``chain.*``, ``sift.*`` and ``alice.splice``
spans, per window Bob finalized while traced."""

from qkdbench import chain_spans, program_spans


def read(record):
    found = chain_spans.outermost(record)
    if found is None:
        return None
    spans, outer = found
    return program_spans.per_window_ms(
        spans, sum(spans.clipped(sp) for sp in outer))
