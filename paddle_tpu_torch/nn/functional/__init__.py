"""Functionals of ``paddle.nn.functional`` that the ported models use."""
from .attention import (flash_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .loss import cross_entropy  # noqa: F401

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "cross_entropy"]
