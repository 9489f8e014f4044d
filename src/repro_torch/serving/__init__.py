"""The serving path (counterpart of :mod:`repro.serving`): the paged KV
pool, the host engine and the device engine as CUDA graphs."""
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.engine_graph import GraphServingEngine
from repro_torch.serving.kv_cache import PagedKVPool

__all__ = ["ServingEngine", "EngineConfig", "Request", "PagedKVPool",
           "GraphServingEngine"]
