"""Serving steps (twin of ``repro.train``; the training step, the
optimizer and the loop wait for the training slice, ``ROADMAP.md``)."""
from repro_torch.train.step import make_decode_step, make_prefill

__all__ = ["make_decode_step", "make_prefill"]
