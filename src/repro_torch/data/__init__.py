from repro_torch.data.synthetic import DataConfig, SyntheticLM, make_dataset

__all__ = ["DataConfig", "SyntheticLM", "make_dataset"]
