"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel's wrapper launches the CUDA kernel for a CUDA tensor (or raises)
and runs the plain version for a CPU tensor; ``LAUNCHES`` in the kernel's
module (``FWD_LAUNCHES``/``BWD_LAUNCHES`` for the max pool) counts real
launches. Sources live in ``csrc/`` and are compiled by
``_build`` at first use, never at import.
"""
