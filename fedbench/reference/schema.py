"""The parts of the parameter list that every model family shares, kept
here so that neither the weight maker nor the plain reference has to ask
the program. A family's own layers are in `fedbench/families/<family>.py`.

Each entry is (key, shape, storage dtype, init, fan_in). The keys are the
flat paths of the port's parameter tree (`blocks/<i>_<kind>/...` with the
stacked leading layer dim), so one flat dict of tensors serves both sides.
`init` is "embed", "normal", "ones", "zeros" or one of the family's own
(its `INITS`); `fan_in` is the size a "normal" leaf's products contract
over.
"""
from __future__ import annotations

import importlib
from typing import List, Tuple

import torch

Entry = Tuple[str, Tuple[int, ...], torch.dtype, str, int]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def get(cfg: dict, *names):
    """The first of `names` that the file holds: a transformers config
    and a mamba_ssm config name the same size differently."""
    for name in names:
        if name in cfg:
            return cfg[name]
    raise KeyError(f"the configuration names none of {names}")


def lm_dims(cfg: dict) -> dict:
    """The sizes every family has: width, vocabulary, depth, norm epsilon,
    tied head and stored dtype. The vocabulary is padded up to
    `pad_vocab_size_multiple` where the file names one, as mamba_ssm pads
    its embedding table."""
    v = cfg["vocab_size"]
    pad = cfg.get("pad_vocab_size_multiple", 1)
    return {"d": get(cfg, "hidden_size", "d_model"), "v": -(-v // pad) * pad,
            "layers": get(cfg, "num_hidden_layers", "n_layer"),
            "eps": get(cfg, "rms_norm_eps", "norm_epsilon"),
            "tied": get(cfg, "tie_word_embeddings", "tie_embeddings"),
            "dtype": DTYPES[cfg["torch_dtype"]]}


def lm_entries(z: dict) -> List[Entry]:
    """The embedding table, the final norm and, where the head is not
    tied, the output head."""
    d, v = z["d"], z["v"]
    out = [("embed/table", (v, d), z["dtype"], "embed", 0),
           ("final_norm/scale", (d,), torch.float32, "ones", 0)]
    if not z["tied"]:
        out.append(("lm_head/table", (d, v), z["dtype"], "normal", d))
    return out


def dims(cfg: dict) -> dict:
    """The sizes of the configuration's family, as the metric readers
    read them (`ctx["dims"]`)."""
    return importlib.import_module(
        f"fedbench.families.{cfg['family']}").dims(cfg)
