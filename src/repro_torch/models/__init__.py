"""The LM model zoo: the dense, moe, hybrid, ssm, audio and vlm families
(port of ``repro.models``)."""
from repro_torch.models.model_zoo import (  # noqa: F401
    Model,
    build,
    input_axes,
    input_specs,
    long_context_variant,
    runs_shape,
)
