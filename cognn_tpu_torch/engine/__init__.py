from cognn_tpu_torch.engine.gas import GasEngine  # noqa: F401
from cognn_tpu_torch.engine.plan import (  # noqa: F401
    DevicePlan,
    build_device_plan,
)
