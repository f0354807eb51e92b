from .synthetic import SyntheticSOD

__all__ = ["SyntheticSOD"]
