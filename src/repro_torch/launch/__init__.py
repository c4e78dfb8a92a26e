"""Launchers (counterpart of ``repro.launch``): the serving driver
``repro_torch.launch.serve`` and the training driver
``repro_torch.launch.train``."""
