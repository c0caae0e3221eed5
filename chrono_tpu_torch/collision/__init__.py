"""Uniform-grid binning (counterpart of ``chrono_tpu.collision``)."""
