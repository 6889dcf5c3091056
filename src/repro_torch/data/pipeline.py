"""Deterministic, resumable, sharded synthetic data pipeline — a copy of
`repro.data.pipeline` (the port imports nothing of the JAX package).

Every batch is a pure numpy function of (seed, step, shard), so both
packages draw the same bytes, a restarted run resumes mid-stream from its
checkpointed step, and each data shard draws disjoint streams.  Token
statistics follow a Zipfian unigram over the arch's vocab.

Family-aware: frames and a mask for the audio encoder, patch embeddings
and M-RoPE position triples for the VLM, token/target pairs otherwise.
`to_device` turns a batch into tensors on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    num_shards: int = 1
    shard: int = 0


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard]))


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    ranks = rng.zipf(1.2, size=shape).astype(np.int64)
    return np.minimum(ranks - 1, vocab - 1).astype(np.int32)


def make_batch(mcfg: ModelConfig, dcfg: DataConfig, step: int) -> dict:
    """One training batch (numpy arrays) for this shard at this step."""
    rng = _rng(dcfg, step)
    b = dcfg.batch // dcfg.num_shards
    s = dcfg.seq_len
    if mcfg.family == "audio":
        frames = rng.standard_normal((b, s, mcfg.d_model)).astype(np.float32)
        mask = rng.random((b, s)) < 0.3
        targets = _zipf_tokens(rng, (b, s), mcfg.vocab_size)
        return {"frames": frames, "mask": mask, "targets": targets,
                "target_mask": mask.astype(np.float32)}
    if mcfg.family == "vlm":
        sv = s // 4
        st = s - sv
        toks = _zipf_tokens(rng, (b, st + 1), mcfg.vocab_size)
        patches = rng.standard_normal((b, sv, mcfg.d_model)).astype(np.float32)
        positions = np.broadcast_to(np.arange(s)[None, None, :], (b, 3, s))
        return {
            "tokens": toks[:, :-1], "targets": toks[:, 1:],
            "patch_embeds": patches,
            "positions": np.ascontiguousarray(positions),
        }
    toks = _zipf_tokens(rng, (b, s + 1), mcfg.vocab_size)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def batches(mcfg: ModelConfig, dcfg: DataConfig,
            start_step: int = 0) -> Iterator[dict]:
    """Resumable stream: `batches(..., start_step=k)` reproduces exactly the
    stream a fresh run would see from step k."""
    step = start_step
    while True:
        yield make_batch(mcfg, dcfg, step)
        step += 1


def to_device(batch: dict, device: torch.device | str) -> dict:
    """The batch's arrays as tensors on `device`, dtypes kept."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
