"""Minimal end-to-end programs on the port (ports of the repo's
``examples/``), run as ``python -m cognn_tpu_torch.examples.<name>``; each
runs on the card unless given ``--device cpu``."""
