from .model import Model, summary, flops  # noqa: F401
