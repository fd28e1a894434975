"""Launchers of the port: the batched LM serving demo
(:mod:`repro_torch.launch.serve`) and the training driver with its model
presets (:mod:`repro_torch.launch.train`)."""
