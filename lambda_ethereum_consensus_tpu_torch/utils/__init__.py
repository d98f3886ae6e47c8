"""Small helpers shared across the port (:mod:`.env`)."""
