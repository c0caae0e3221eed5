"""Host-side helpers (counterpart of ``chrono_tpu.utils``): carriers,
the device rule, CUDA-graph capture, samplers, segment sums, filters,
timers and the validation norms."""

from chrono_tpu_torch.utils import filters, samplers, timers, validation
