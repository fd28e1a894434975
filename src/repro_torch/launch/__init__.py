"""Launchers of the port: the batched LM serving demo
(:mod:`repro_torch.launch.serve`), the training driver with its model
presets (:mod:`repro_torch.launch.train`), and the launch tooling:
device-free production meshes with the H100 constants
(:mod:`~repro_torch.launch.mesh`), the op-level cost counter
(:mod:`~repro_torch.launch.op_analysis`), the roofline
(:mod:`~repro_torch.launch.roofline`) and the meta-device dry run
(:mod:`~repro_torch.launch.dryrun`)."""
