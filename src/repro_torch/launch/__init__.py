"""Launch-side helpers: the fleet replay's device mesh (``mesh``) and the
batched serving driver (``serve``)."""
