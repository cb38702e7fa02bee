"""Drivers of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``), their step builders and the
mesh and sharding rules of training over ranks."""
