"""Serving: packed or fake-quant weights, KV cache (contiguous or paged,
full or quantized per layer, with prefix sharing), greedy engine, residency
bytes and the continuous-batching scheduler."""
from repro_torch.serve.config import EngineSpec
from repro_torch.serve.engine import ServeEngine, quantize_for_serving
from repro_torch.serve.packing import pack_params
from repro_torch.serve.paging import PageAllocator, PrefixRegistry
from repro_torch.serve.sampling import GREEDY, SamplerConfig
from repro_torch.serve.scheduler import (Completion,
                                         ContinuousBatchingScheduler,
                                         Request, serve_all)

__all__ = ["Completion", "ContinuousBatchingScheduler", "EngineSpec",
           "GREEDY", "PageAllocator", "PrefixRegistry", "Request",
           "SamplerConfig", "ServeEngine", "pack_params",
           "quantize_for_serving", "serve_all"]
