from .datasets import CrackDataSet, CrackDataSetTest, SubsetView, SyntheticCrackDataSet
from .loader import IterationBasedLoader
from .transforms import TestTransforms, TrainTransforms

__all__ = ["CrackDataSet", "CrackDataSetTest", "IterationBasedLoader", "SubsetView",
           "SyntheticCrackDataSet", "TestTransforms", "TrainTransforms"]
