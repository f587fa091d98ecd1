from torchfcn.models.registry import build, get_spec, names  # noqa: F401
