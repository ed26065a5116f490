from repro_torch.engine.batched import make_analysis_fn

__all__ = ["make_analysis_fn"]
