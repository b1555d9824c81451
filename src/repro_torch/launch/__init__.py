"""Launch-side helpers: the fleet replay's device mesh (``mesh``)."""
