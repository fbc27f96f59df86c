"""Host milliseconds a window that the consumer's thread spends inside
the program's drain (its ``drain`` spans: the join on the drain worker,
the inline unpack and the sort), per window Bob finalized while traced:
the program's part of what ``key_pull_ms_per_window`` times from
outside."""

from qkdbench import program_spans


def read(record):
    spans = program_spans.read(record)
    if spans is None:
        return None
    return program_spans.per_window_ms(
        spans, sum(spans.clipped(sp) for sp in spans.named("drain", "main")))
