"""Simulated devices replayed and folded per second in a fleet query cell:
``lanes_per_s``'s reading (every lane of every call of the window over the
time from the first call's start to the last call's end, host clock),
under a name of its own so that the host-bound query cells carry their
own bound."""

from benchcore import spec

read = spec.reader("lanes_per_s")
