from torchfcn.models.registry import build, get_spec  # noqa: F401
