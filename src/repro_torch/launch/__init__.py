"""Launchers (twin of ``repro.launch``): ``python -m repro_torch.launch.train``
and ``python -m repro_torch.launch.coschedule``."""
