from cognn_tpu_torch.mpc.engine import MpcGasEngine  # noqa: F401
from cognn_tpu_torch.mpc.protocol import Protocol  # noqa: F401
