from .datasets import (CrackDataSet, CrackDataSetTest, MassRoadDataset, RetinalDataSet,
                       RetinalDataSetTest, SRPretrainDataSet, SubsetView, SyntheticCrackDataSet,
                       TTICrackDataSetTest)
from .loader import IterationBasedLoader
from .transforms import TestTransforms, TrainTransforms

__all__ = ["CrackDataSet", "CrackDataSetTest", "IterationBasedLoader", "MassRoadDataset",
           "RetinalDataSet", "RetinalDataSetTest", "SRPretrainDataSet", "SubsetView",
           "SyntheticCrackDataSet", "TTICrackDataSetTest", "TestTransforms", "TrainTransforms"]
