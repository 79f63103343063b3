"""Serving engine of the port: paged KV cache and continuous batching."""
from .engine import EngineConfig, ServeRequest, ServingEngine
from .metrics import RequestMetrics, ServeMetrics
from .page_table import PageManager, PageState

__all__ = ["EngineConfig", "PageManager", "PageState", "RequestMetrics",
           "ServeMetrics", "ServeRequest", "ServingEngine"]
