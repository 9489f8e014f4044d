"""Synthetic token batches and the prefetching input pipeline
(counterpart of :mod:`repro.data`)."""
from repro_torch.data.pipeline import PrefetchPipeline, SyntheticTokens

__all__ = ["PrefetchPipeline", "SyntheticTokens"]
