"""Phi calibration and L1/L2 decomposition (port of ``repro.core``)."""
