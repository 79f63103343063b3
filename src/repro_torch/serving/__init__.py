"""Serving engine of the port: paged KV cache, continuous batching, and the
SLO-aware serving plan search (``slo_search.py``)."""
from .engine import EngineConfig, ServeRequest, ServingEngine
from .metrics import RequestMetrics, ServeMetrics
from .page_table import PageManager, PageState
from .slo_search import (DECODE_BW_EFFICIENCY, PAGE_SIZE_CANDIDATES,
                         ServingCostModel, ServingModelStats,
                         ServingPlanSearch, SloPoint)

__all__ = ["DECODE_BW_EFFICIENCY", "EngineConfig", "PAGE_SIZE_CANDIDATES",
           "PageManager", "PageState", "RequestMetrics", "ServeMetrics",
           "ServeRequest", "ServingCostModel", "ServingEngine",
           "ServingModelStats", "ServingPlanSearch", "SloPoint"]
