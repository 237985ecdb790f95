"""Parameter specs and their initialisation (the single-device half of the
reference's ``distributed/`` package; the mesh half waits for the
multi-device port)."""
