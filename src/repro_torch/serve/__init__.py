"""Serving: packed weights, KV cache, greedy engine."""
from repro_torch.serve.config import EngineSpec
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.packing import pack_params
from repro_torch.serve.sampling import GREEDY, SamplerConfig

__all__ = ["EngineSpec", "GREEDY", "SamplerConfig", "ServeEngine",
           "pack_params"]
