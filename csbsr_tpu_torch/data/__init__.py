from .datasets import (CrackDataSet, CrackDataSetTest, RetinalDataSetTest, SubsetView,
                       SyntheticCrackDataSet, TTICrackDataSetTest)
from .loader import IterationBasedLoader
from .transforms import TestTransforms, TrainTransforms

__all__ = ["CrackDataSet", "CrackDataSetTest", "IterationBasedLoader", "RetinalDataSetTest",
           "SubsetView", "SyntheticCrackDataSet", "TTICrackDataSetTest", "TestTransforms",
           "TrainTransforms"]
