"""Training and serving steps (twin of ``repro.train``); the loop is
``train.loop.Trainer``."""
from repro_torch.train.step import init_state, make_decode_step, make_prefill, make_train_step

__all__ = ["init_state", "make_decode_step", "make_prefill", "make_train_step"]
