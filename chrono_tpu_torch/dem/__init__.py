"""Granular DEM: the cell-slot settling path (counterpart of
``chrono_tpu.dem``)."""
