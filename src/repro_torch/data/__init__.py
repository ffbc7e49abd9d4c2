from .pipeline import DataConfig, SyntheticLM, make_iterator

__all__ = ["DataConfig", "SyntheticLM", "make_iterator"]
