"""Host microseconds a call of the program's decoder takes (its
``decode`` span: the checks, the launch plan and the launch), averaged
over the calls inside the traced window."""

from qkdbench import program_spans


def read(record):
    spans = program_spans.read(record)
    if spans is None:
        return None
    calls = [sp.end - sp.start for sp in spans.named("decode")
             if spans.t0 <= sp.start and sp.end <= spans.t1]
    return sum(calls) / len(calls) if calls else None
