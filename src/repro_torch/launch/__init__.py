"""Launchers of the port: the batched LM serving demo
(:mod:`repro_torch.launch.serve`) and the model presets
(:mod:`repro_torch.launch.train`; its training loop waits, ROADMAP item 9c)."""
