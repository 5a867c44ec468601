"""Egress pricing for client-update transfers.

`TransferRates` is the transfer sibling of `cloud.pricing.StorageRates`:
a tiny frozen rate card hung off `Provider` (as `Provider.transfer`)
that turns an upload size into dollars. The live `CostAccountant`
prices every `ClientUpdateSent` through the sending provider's card and
publishes a `TransferBilled` event for any non-zero charge, so replayed
logs rebuild transfer dollars from the recorded `TransferBilled` stream
without needing a price book — the same live/replay split
`CheckpointBilled` uses for storage.

Rates default to zero: providers configured before the comms subsystem
existed bill no egress, which keeps every pre-v7 golden total unmoved.

Layering: pure stdlib — `cloud.pricing` imports *from* here, never the
reverse.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TransferRates:
    """Per-provider egress rate card for client-update uploads.

    `egress_usd_per_mb` prices the bytes a client sends back to the
    server (cloud egress is billed at the sender). The zero default
    makes transfer billing strictly opt-in.
    """
    egress_usd_per_mb: float = 0.0

    def transfer_cost(self, size_mb: float) -> float:
        """Dollars to egress one `size_mb` client update."""
        if size_mb <= 0.0:
            return 0.0
        return size_mb * self.egress_usd_per_mb
