"""Mean real windows per beam-gang decode over the traced slice (not the
padded bucket): the ``members`` of the port's ``gang.decode`` counters,
one taken as each decode ends, over the decodes that ended while the
device trace recorded (``serving/device_trace.last().summary()``)."""

from benchmark.harness import reader


def read(view):
    s = reader("idle_pct.workers").summary(view)
    return None if s is None else s["counters"]["gang_members"]
