"""Command-line tools of the port (``python -m kgdet_tpu_torch.tools.test``)
and chip-side measurement scripts."""
