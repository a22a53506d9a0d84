"""PyTorch + CUDA port of the EcoSched co-scheduler (twin of ``repro``).

The port imports torch and numpy, never JAX and nothing of ``repro``.
Host-side decision logic (enumeration, caches, the event loop, energy
accounting) is carried over from the reference bit for bit; the Eq. (1)
score reduction runs in the hand-written kernels of
``repro_torch.kernels``.  The scheduler daemon is ``python -m
repro_torch.cli``; its journal is the reference's format.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
