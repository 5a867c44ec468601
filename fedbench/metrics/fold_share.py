"""fold_share: the FedAvg fold's share of the traced window. It reads the
program's spans: the device wall of every participant's `fl.fold` (its
delta, the codec's round trip, the weighting and the sum) and of the
round's `fl.apply` (the new global parameters)."""
from fedbench.harness import spans


def read(ctx):
    return spans.window_share(ctx, "fl.fold", "fl.apply")
