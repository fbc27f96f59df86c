"""The events cell's reading of the program's sifting spans: the loop
thread's outermost ``chain.*``, ``sift.*`` and ``alice.splice`` spans
(``qtpu_torch.chain``'s framing, sifting and splice), mapped onto the
trace's clock by ``program_spans``."""

from __future__ import annotations

from qkdbench import program_spans

__all__ = ["is_sift", "outermost"]


def is_sift(sp) -> bool:
    return sp.name.startswith(("chain.", "sift.")) or sp.name == "alice.splice"


def outermost(record):
    """(spans, the outermost sifting spans on the loop's thread), or None
    where the run holds no program span or none of these."""
    spans = program_spans.read(record)
    if spans is None:
        return None
    by_id = {sp.id: sp for sp in spans.spans}
    out = []
    for sp in spans.spans:
        if not is_sift(sp) or sp.thread != spans.main:
            continue
        up = by_id.get(sp.parent)
        while up is not None and not is_sift(up):
            up = by_id.get(up.parent)
        if up is None:
            out.append(sp)
    return (spans, out) if out else None
