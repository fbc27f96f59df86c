"""Host milliseconds the key consumer's pulls block the loop, per window
Bob finalized in the window."""


def read(record):
    windows = record.get("windows")
    if "pull_s" not in record or not windows:
        return None
    return 1e3 * record["pull_s"] / windows
