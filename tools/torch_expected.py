#!/usr/bin/env python3
"""Rewrite the JAX package's committed benchmark outputs, which the
port is held to where no JAX is installed (`chip_smoke.py` on the
card's host).

    PYTHONPATH=src python3 tools/torch_expected.py [STEM ...]

For each run of `repro_torch.benchmarks.expected.RUNS` (all, or the
STEMs named), runs the JAX package's script as its users run it
(`python -m benchmarks.<name> ARGS`, the example as a script) in a
temporary directory, so the scaling run's relative `--out` lands there,
and writes its standard output, masked by `expected.deterministic`, to
tests/torch_expected/benchmarks/<STEM>.txt. Needs both packages (JAX on
the CPU).
"""
import contextlib
import io
import os
import runpy
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro_torch.benchmarks import expected  # noqa: E402


def reference_output(stem: str) -> str:
    """The JAX package's standard output of the run `stem`, masked."""
    module, argv = expected.spec(stem)
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    out = io.StringIO()
    old_argv, old_cwd = sys.argv, os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "build"))
        sys.argv = [path, *(argv or ())]
        os.chdir(d)
        try:
            with contextlib.redirect_stdout(out):
                runpy.run_path(path, run_name="__main__")
        except SystemExit as e:
            if e.code not in (None, 0):
                raise
        finally:
            sys.argv = old_argv
            os.chdir(old_cwd)
    return expected.deterministic(out.getvalue())


def main(argv=None):
    stems = list(sys.argv[1:] if argv is None else argv) or expected.STEMS
    os.makedirs(expected.EXPECTED_DIR, exist_ok=True)
    for stem in stems:
        text = reference_output(stem)
        (expected.EXPECTED_DIR / f"{stem}.txt").write_text(text)
        print(f"{stem}: {len(text.splitlines())} lines -> "
              f"{expected.EXPECTED_DIR / f'{stem}.txt'}")


if __name__ == "__main__":
    main()
