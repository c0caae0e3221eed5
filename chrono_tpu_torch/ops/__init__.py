"""Hand-written kernels (counterpart of ``chrono_tpu.ops``)."""
