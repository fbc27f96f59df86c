"""The layered decode kernel's share of its roofline, in percent
(``readers.bp_layered_roofline``)."""

from qkdbench.readers import bp_layered_roofline as read  # noqa: F401
