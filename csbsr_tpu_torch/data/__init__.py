from .datasets import CrackDataSetTest

__all__ = ["CrackDataSetTest"]
