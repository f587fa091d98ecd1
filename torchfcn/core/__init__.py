from torchfcn.core.config import (  # noqa: F401
    IMAGENET_BGR_MEAN, DetectorConfig, GridConfig)
