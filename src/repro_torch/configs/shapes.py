"""Meta-tensor input stand-ins for every (arch x shape) dry-run cell, the
port of the JAX package's `configs/shapes.py`.

Meta tensors carry shapes and dtypes and no data, so nothing is
allocated: the dry run (`launch/dryrun.py`) runs each cell's step on
them. Shapes and dtypes are the reference's (int32 token ids and
positions).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.models import lm


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok_struct(cfg: ModelConfig, batch: int, seq: int):
    if cfg.family == "audio":
        # EnCodec frontend stub: precomputed frame embeddings
        return _meta((batch, seq, cfg.d_model), cfg.activation_dtype)
    return _meta((batch, seq), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Returns the kwargs tree for the step function of `shape.kind`."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = {"tokens": _tok_struct(cfg, B, S),
                 "labels": _meta((B, S), torch.int32)}
        if cfg.family == "vlm":
            batch["cond"] = _meta((B, cfg.n_cond_tokens, cfg.d_model),
                                  cfg.activation_dtype)
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": _tok_struct(cfg, B, S)}
        if cfg.family == "vlm":
            out["cond"] = _meta((B, cfg.n_cond_tokens, cfg.d_model),
                                cfg.activation_dtype)
        return out
    if shape.kind == "decode":
        return {
            "tokens": _tok_struct(cfg, B, 1),
            "pos": _meta((B,), torch.int32),
            "cache": lm.abstract_cache(cfg, B, S),
        }
    raise ValueError(shape.kind)
