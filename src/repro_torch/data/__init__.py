from repro_torch.data.pipeline import (SyntheticLMDataset, TokenFileDataset,
                                       make_train_iterator)

__all__ = ["SyntheticLMDataset", "TokenFileDataset", "make_train_iterator"]
