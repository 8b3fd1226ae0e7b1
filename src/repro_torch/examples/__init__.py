"""Examples of the port, each run as
``python -m repro_torch.examples.<name>``."""
