"""Per cent of the window in which no operation ran on the card: one
less the union of the trace's operation intervals over the window."""

from bench_port.readers import idle_share as read  # noqa: F401
