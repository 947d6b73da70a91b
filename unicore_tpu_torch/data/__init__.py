from .dictionary import Dictionary

__all__ = ["Dictionary"]
