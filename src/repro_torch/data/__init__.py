"""Synthetic and byte-level text batches (``repro/data/`` counterpart)."""
from .pipeline import DataConfig, synthetic_lm_batches, text_corpus_batches

__all__ = ["DataConfig", "synthetic_lm_batches", "text_corpus_batches"]
