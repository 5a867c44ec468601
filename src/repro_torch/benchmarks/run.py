"""Benchmark driver: one section per paper table/figure + the roofline
report. Prints ``name,value,derived`` CSV blocks.

  table1   — Table I cost comparison (4 datasets x 3 policies)
  fig4     — client-state timeline (Fed-ISIC2019)
  fig5     — cumulative per-client costs (Fed-ISIC2019)
  scaling  — fleet-core wall/RSS curve (build/BENCH_scaling_torch.json
             in the checkout) + the beyond-paper savings-vs-skew study
  roofline — per (arch x shape x mesh) roofline terms from the dry-run

    PYTHONPATH=src python -m repro_torch.benchmarks.run [section ...]
"""
from __future__ import annotations

import sys


def section(title):
    print(f"\n{'='*72}\n== {title}\n{'='*72}")


def main(argv=None) -> None:
    want = list(sys.argv[1:] if argv is None else argv) or [
        "table1", "fig4", "fig5", "scaling", "preemption", "roofline"]

    if "table1" in want:
        section("Table I: cost & savings across datasets and policies")
        from repro_torch.benchmarks import table1
        table1.main([])         # empty argv: section names aren't flags

    if "fig4" in want:
        section("Fig 4: client operational states over time (Fed-ISIC2019)")
        from repro_torch.benchmarks import fig4_timeline
        fig4_timeline.main([])

    if "fig5" in want:
        section("Fig 5: accumulated per-client cost (Fed-ISIC2019)")
        from repro_torch.benchmarks import fig5_costs
        fig5_costs.main([])

    if "scaling" in want:
        section("Fleet core: wall-clock / RSS scaling -> "
                "build/BENCH_scaling_torch.json")
        from repro_torch.benchmarks import scaling
        scaling.main([])
        section("Beyond-paper: savings vs pool size / heterogeneity")
        scaling.main(["--savings"])

    if "preemption" in want:
        section("Beyond-paper: robustness vs spot preemption rate")
        from repro_torch.benchmarks import preemption_sweep
        preemption_sweep.main()

    if "roofline" in want:
        section("Roofline: per (arch x shape x mesh) terms from dry-run")
        from repro_torch.benchmarks import roofline_report
        roofline_report.main()


if __name__ == "__main__":
    main()
