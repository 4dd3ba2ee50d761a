from .attention import dot_product_attention

__all__ = ["dot_product_attention"]
