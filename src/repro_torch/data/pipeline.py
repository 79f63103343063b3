"""Deterministic data pipeline: the port's numpy copy of
``repro/data/pipeline.py``, yielding the same bytes for the same seed.

Two sources, both host-side numpy generators:

  * ``synthetic_lm_batches`` — seeded Zipf-like token stream for
    benchmarking and smoke tests,
  * ``text_corpus_batches`` — byte-level tokenization of a local text file
    (self-contained; no external tokenizer), packed into fixed-length
    sequences for the end-to-end example run.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 1234
    vision_tokens: int = 0
    d_vision: int = 0
    encoder_seq: int = 0
    d_model: int = 0            # for audio frame stubs
    pad_id: int = 0


def _lm_batch(rng: np.random.Generator, cfg: DataConfig) -> Dict[str, np.ndarray]:
    # Zipf-ish marginal so losses behave like text, fully deterministic.
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len + 1),
                      p=probs).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.vision_tokens:
        batch["patches"] = rng.standard_normal(
            (cfg.global_batch, cfg.vision_tokens, cfg.d_vision)).astype(np.float32)
    if cfg.encoder_seq:
        batch["frames"] = rng.standard_normal(
            (cfg.global_batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def synthetic_lm_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed)
    while True:
        yield _lm_batch(rng, cfg)


def text_corpus_batches(path: str | pathlib.Path,
                        cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Byte-level LM over a local text file, packed and epoch-shuffled."""
    data = np.frombuffer(pathlib.Path(path).read_bytes(), dtype=np.uint8)
    data = data.astype(np.int32) % cfg.vocab_size
    n_tok = cfg.seq_len + 1
    n_seqs = len(data) // n_tok
    assert n_seqs > 0, "corpus smaller than one sequence"
    packed = data[: n_seqs * n_tok].reshape(n_seqs, n_tok)
    rng = np.random.default_rng(cfg.seed)
    while True:
        order = rng.permutation(n_seqs)
        for i in range(0, n_seqs - cfg.global_batch + 1, cfg.global_batch):
            rows = packed[order[i:i + cfg.global_batch]]
            yield {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
