"""Spiking models, LIF neurons and synthetic data (port of ``repro.snn``)."""
