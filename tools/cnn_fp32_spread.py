#!/usr/bin/env python3
"""How far two correct runs of the paper's CNNs part ways: the numbers
behind the bars `chip_smoke.py`'s `PAPER_PARITY` and the CNN parity
tests hold the port to.

    python3 tools/cnn_fp32_spread.py [--device cuda|cpu]

For each Table I model at its dataset's size and full width, on the
smallest client of `repro_torch.examples.paper_reproduction`'s
1,500-image partition, on the CPU:
  * its first batch's gradient in fp32 against float64: the worst and
    the median leaf, in units of 1e-4 of the leaf's largest entry
    (`chip_smoke._grad_ratios`);
  * its local epoch with the forward and backward in fp32 against
    float64 (adamw is fp32 in both), in units of the multi-step bar
    (`chip_smoke._update_ratios`).
On the card (the default), also the card's float64 epoch and first step
against the CPU's. A ratio above 1 is outside the bar.
"""
import argparse
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    from repro_torch.common.device import require_device
    from repro_torch.examples import paper_reproduction as PR
    require_device(device, "cnn_fp32_spread")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, f64 = torch.float32, torch.float64
    for dataset, model in PR.MODELS.items():
        fed = PR.Federation(dataset, 1500, "cpu")
        i = min(range(len(fed.parts)), key=lambda j: len(fed.parts[j]))
        g = smoke._grad_ratios(smoke._paper_grads(fed, i, "cpu", f32),
                               smoke._paper_grads(fed, i, "cpu", f64))
        worst, leaf = smoke._worst(g)
        print(f"{model} client_{i}: first-batch gradient fp32 vs float64 "
              f"on the CPU: worst leaf {worst:.3g} of the bar ({leaf}), "
              f"median leaf {statistics.median(g.values()):.3g}")
        init = smoke._paper_init(fed)
        cpu64 = smoke._paper_train(fed, i, "cpu", f64, None)
        runs = {"fp32 on the CPU": smoke._paper_train(fed, i, "cpu", f32,
                                                      None)}
        if device != "cpu":
            runs["float64 on the card"] = smoke._paper_train(
                fed, i, device, f64, None)
        for name, run in runs.items():
            worst, leaf = smoke._worst(
                smoke._update_ratios(run[0], cpu64[0], init)[0])
            print(f"{model} client_{i}: local epoch ({run[3]} batches), "
                  f"{name} vs float64 on the CPU: worst leaf {worst:.3g} "
                  f"of the bar ({leaf}); loss {run[1]:.6f} vs "
                  f"{cpu64[1]:.6f}")
        if device != "cpu":
            one = [smoke._paper_train(fed, i, d, f64, 1)
                   for d in (device, "cpu")]
            worst, leaf = smoke._worst(
                smoke._update_ratios(one[0][0], one[1][0], init)[0])
            g = smoke._grad_ratios(smoke._paper_grads(fed, i, device, f64),
                                   smoke._paper_grads(fed, i, "cpu", f64))
            print(f"{model} client_{i}: first step in float64, card vs "
                  f"CPU: params at {worst:.3g} of the bar ({leaf}), "
                  f"gradients at {smoke._worst(g)[0]:.3g}")


if __name__ == "__main__":
    main()
