"""The LM model zoo, dense family (port of ``repro.models``)."""
from repro_torch.models.model_zoo import (  # noqa: F401
    Model,
    build,
    long_context_variant,
)
