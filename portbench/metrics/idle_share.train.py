"""1 - the union of the device's activity over the window, in %."""

from portbench.readers import idle_share as read  # noqa: F401
