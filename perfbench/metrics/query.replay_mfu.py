"""``replay_mfu``'s reading in a fleet query cell, which moves
``query_lanes_per_s`` in place of ``lanes_per_s``."""

from benchcore import spec

read = spec.reader("replay_mfu")
