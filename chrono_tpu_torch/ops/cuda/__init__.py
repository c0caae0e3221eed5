"""CUDA C++ kernels for Hopper (``sm_90a``), each with a plain PyTorch twin.

Every wrapper dispatches on the device of the tensors it is given: a CPU
tensor runs the twin, a CUDA tensor launches the kernel (built from
``chrono_tpu_torch/csrc`` on first use) or raises.  Each wrapper counts its
kernel launches in a plain integer attribute, ``wrapper.launches``.
"""
