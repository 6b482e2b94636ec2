from repro_torch.data.pipeline import (SyntheticLMData, DataState,
                                       make_pipeline)

__all__ = ["SyntheticLMData", "DataState", "make_pipeline"]
