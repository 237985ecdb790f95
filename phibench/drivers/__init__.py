"""Closed-loop drivers of the program's entry points, one per kind of
traffic mix (the ``kind`` of a file under ``workloads/``)."""
