"""The PA hash's share of its roofline, in percent: every kernel launched
inside the benchmark's span around the window programs' ``pa`` calls
(``readers.pa_roofline``)."""

from qkdbench.readers import pa_roofline as read  # noqa: F401
