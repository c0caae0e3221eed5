"""Fluid–solid interaction (counterpart of ``chrono_tpu.fsi``)."""
