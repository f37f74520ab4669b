from .factory import get_model

__all__ = ["get_model"]
