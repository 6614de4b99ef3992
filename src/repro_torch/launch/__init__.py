"""Launchers: LM serving (``python -m repro_torch.launch.serve``)."""
