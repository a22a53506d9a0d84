"""Hardware constants (twin of ``repro.roofline``; only ``hw`` so far)."""
