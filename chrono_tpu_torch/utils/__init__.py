"""Host-side helpers (counterpart of ``chrono_tpu.utils``)."""
