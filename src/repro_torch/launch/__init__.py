"""Launch-side helpers: the fleet replay's device mesh (``mesh``), the
batched serving driver (``serve``) and the resumable trainer
(``train``)."""
