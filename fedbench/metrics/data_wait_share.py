"""data_wait_share: the data draw's share of the traced window. It reads
the program's spans: the device wall of `fl.data_draw` (every slot's
batches drawn on the host and copied to the device), the idle it leaves
the device included."""
from fedbench.harness import spans


def read(ctx):
    return spans.window_share(ctx, "fl.data_draw")
