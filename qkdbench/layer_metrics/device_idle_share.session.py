"""The card's idle share of the traced window, in percent
(``readers.idle_share``)."""

from qkdbench.readers import idle_share as read  # noqa: F401
