"""The host-only benchmark runs held to the JAX package's output.

Each run in `RUNS` is one the section driver's users make: the driver
over Table I, Fig. 4, Fig. 5 and the preemption sweep, the preemption
realism, multi-cloud, accounting and scaling benchmarks, and the
preemption example. The JAX package's output of each, with the lines
that vary from run to run masked (`deterministic`: wall seconds, RSS
and speedups), is committed as `tests/torch_expected/benchmarks/
<stem>.txt`, so a machine with the port and no JAX holds the port to it
(`chip_smoke.py` on the card's host, tests/test_torch_benchmarks.py on
the CPU). `python tools/torch_expected.py` rewrites the files from the
JAX package.
"""
from __future__ import annotations

import contextlib
import importlib
import io
import re
from pathlib import Path
from typing import Optional, Tuple

# the checkout's committed outputs (this file is
# src/repro_torch/benchmarks/expected.py)
EXPECTED_DIR = (Path(__file__).resolve().parents[3] / "tests"
                / "torch_expected" / "benchmarks")
SCALING_OUT = "build/BENCH_scaling_torch.json"

# (stem, module under repro_torch (the JAX package's: under the
# checkout), main's argv or None for a main that takes none)
RUNS: Tuple[Tuple[str, str, Optional[Tuple[str, ...]]], ...] = (
    ("run", "benchmarks.run", ("table1", "fig4", "fig5", "preemption")),
    ("preemption_realism", "benchmarks.preemption_realism", ()),
    ("multicloud", "benchmarks.multicloud", ()),
    ("accounting_bench", "benchmarks.accounting_bench", None),
    ("scaling", "benchmarks.scaling",
     ("--sizes", "100,1000,10000,100000", "--per-object-at", "1000",
      "--out", SCALING_OUT)),
    ("scaling_savings", "benchmarks.scaling", ("--savings",)),
    ("preemption_and_budgets", "examples.preemption_and_budgets", None),
)
STEMS = tuple(stem for stem, _, _ in RUNS)

# what varies from run to run, each with its mask
_MASKS = (
    (re.compile(r"wall=\s*[0-9.]+s"), "wall=<s>"),
    (re.compile(r"rss=\s*[0-9.]+MiB"), "rss=<MiB>"),
    (re.compile(r"(speedup at n=\d+): [0-9.]+x"), r"\1: <x>"),
    (re.compile(r"^(legacy_scan|sim_indexed|accountant),[0-9.]+,[0-9.]+$",
                re.M), r"\1,<s>,<us>"),
    (re.compile(r"(speedup): [0-9.]+x"), r"\1: <x>"),
)


def deterministic(text: str) -> str:
    """`text` with its wall seconds, RSS and speedups masked."""
    for pattern, mask in _MASKS:
        text = pattern.sub(mask, text)
    return text


def spec(stem: str):
    """(module, argv) of the run `stem`."""
    for s, module, argv in RUNS:
        if s == stem:
            return module, argv
    raise KeyError(f"no run {stem!r}; known: {list(STEMS)}")


def capture(stem: str) -> str:
    """The port's standard output of the run `stem`; its asserts
    raise."""
    module, argv = spec(stem)
    main = importlib.import_module(f"repro_torch.{module}").main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main() if argv is None else main(list(argv))
    return out.getvalue()


def expected(stem: str) -> str:
    """The JAX package's committed output of the run `stem`."""
    return (EXPECTED_DIR / f"{stem}.txt").read_text()
