"""Per cent of the profiled slice in which no operation ran on the card
(layer: the card)."""

from bench.readers import idle_share as read  # noqa: F401
