"""Percent of the blocks of the windows Bob finalized in the window that
were decoded again in a retry round."""


def read(record):
    blocks = record.get("blocks")
    if not blocks:
        return None
    return 100.0 * record["blocks_retried"] / blocks
