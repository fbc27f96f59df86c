"""Host milliseconds a window in both parties' handlers (the top-level
``alice.*``, ``bob.*`` and ``push_sifted`` spans of the loop's thread)
outside the window-program calls (``program.*``), the PA's host side
(``pa.host_total``) and the drain (``drain``) below them, per window Bob
finalized while traced."""

from qkdbench import program_spans


def _handler(sp) -> bool:
    return sp.parent is None and (sp.name.startswith(("alice.", "bob."))
                                  or sp.name == "push_sifted")


def _excluded(sp) -> bool:
    return sp.name.startswith(program_spans.HANDLER_EXCLUDED)


def read(record):
    spans = program_spans.read(record)
    if spans is None:
        return None
    return program_spans.per_window_ms(
        spans, sum(spans.self_us(sp, _excluded) for sp in spans.spans
                   if sp.thread == spans.main and _handler(sp)))
