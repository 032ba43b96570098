"""Entry points: ``python -m repro_torch.launch.serve`` (the one-shot D&A
pipeline and the serving daemon) and ``python -m repro_torch.launch.train``
(DIN's and the GNNs' training)."""
