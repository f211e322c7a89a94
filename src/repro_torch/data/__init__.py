from repro_torch.data.pipeline import DataState, SyntheticLMData

__all__ = ["DataState", "SyntheticLMData"]
