"""Launchers (counterpart of ``repro.launch``): the serving driver
``repro_torch.launch.serve``."""
