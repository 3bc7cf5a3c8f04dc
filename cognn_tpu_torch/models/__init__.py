from cognn_tpu_torch.models.oracle import GasOracle, Metrics  # noqa: F401
