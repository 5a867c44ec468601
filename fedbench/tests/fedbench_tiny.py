"""Tiny cells for the benchmark's CPU tests: a BENCHMARK.json, configuration
and traffic mix of each family at a width the CPU trains in a second, laid
out in a temporary directory as the benchmark lays out its own."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCH = ROOT / "fedbench"
# at float32 the port and the reference compute alike, so a sound round
# reads within rounding: these limits are far above it and far below any
# of the faults
TIGHT = {"loss": 1e-4, "grad": 1e-3, "grad_median": 1e-3, "update": 1e-3}


def tiny_config(kind: str, dtype: str = "float32") -> dict:
    if kind == "attn":
        cfg = json.loads((BENCH / "configs" / "phi3-mini-3.8b-d16.json")
                         .read_text())
        cfg.update(hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=4, vocab_size=128)
    else:
        cfg = json.loads((BENCH / "configs" / "mamba2-1.3b.json")
                         .read_text())
        cfg.update(d_model=64, n_layer=2, vocab_size=125)
        cfg["ssm_cfg"] = dict(cfg["ssm_cfg"], d_state=16, headdim=16,
                              chunk_size=8)
    cfg["torch_dtype"] = dtype
    return cfg


def tiny_mix(arm: str = "int8", batch: int = 2, seq: int = 16) -> dict:
    mix = json.loads((BENCH / "traffic" / "int8.b4x1024.json").read_text())
    mix.update(batch=batch, seq=seq, arm=arm)
    return mix


def lay_out(tmp: Path, kind: str, arm: str = "int8",
            dtype: str = "float32", limits=None, config=None,
            families: Path = BENCH / "families") -> Path:
    """A benchmark root under `tmp` with one cell, "w", of a tiny
    configuration "c" (`config`, or the tiny one of `kind`) under the mix
    "t"; the metric readers are the benchmark's own, and its model
    families are those of the directory `families`."""
    tmp = Path(tmp)
    bench = tmp / "fedbench"
    for sub in ("traffic", "limits", "configs"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    (bench / "metrics").symlink_to(BENCH / "metrics")
    (bench / "families").symlink_to(families)
    (bench / "configs" / "c.json").write_text(
        json.dumps(config or tiny_config(kind, dtype)))
    (bench / "traffic" / "t.json").write_text(json.dumps(tiny_mix(arm)))
    (bench / "limits" / "w.json").write_text(json.dumps(limits or TIGHT))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = {"configs": [{"name": "c", "file": "fedbench/configs/c.json"}],
            "workloads": [{"name": "w", "config": "c", "traffic": "t",
                           "chips": 1}],
            "end_to_end": real["end_to_end"],
            "per_layer": [dict(m, workloads=["w"])
                          for m in real["per_layer"]]}
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def run_cell(root: Path, trace: bool = False, seed: int = 2 ** 31 + 7,
             seconds: float = 0.2):
    """Run the tiny cell on the CPU; returns (exit code, result line,
    standard error)."""
    import io

    from fedbench.harness import session
    out, err = io.StringIO(), io.StringIO()
    # the test process may have loaded the JAX package for other tests;
    # the run may load none of it
    before = set(sys.modules)
    check = session.forbidden_modules
    session.forbidden_modules = lambda: check(set(sys.modules) - before)
    try:
        rc = session.run("w", seed, seconds, trace, device="cpu",
                         root=root, bench_dir=root / "fedbench", out=out,
                         err=err)
    finally:
        session.forbidden_modules = check
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
