"""Uplink bandwidth model: how long a client-update upload takes.

Multi-FedLS measures client→server transfer time as a first-order
term of cross-silo round makespan; FedCostAware's simulator treated
uploads as instantaneous. `UplinkChannel` answers "how many seconds
does `payload_bytes` occupy the uplink of a client in (provider,
zone)?" from per-provider base bandwidth with per-zone overrides —
both configured on `cloud.pricing.Provider` (lifted from
`ProviderConfig.uplink_mbps` / `zone_uplink_mbps`) and both
zero-defaulted, so providers that never opted in keep instantaneous
uploads and every pre-comms round makespan is unchanged.

`CommsModel` bundles one run's payload with its channel: the single
object the engines consult when a client finishes local training.

Layering: duck-types the market (`provider_of`) instead of importing
`cloud.pricing`, so comms stays importable below the cloud layer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.comms.payload import UpdatePayload


class UplinkChannel:
    """Per-(provider, zone) uplink bandwidth lookups.

    `providers` maps provider name -> (base_mbps, {zone: mbps})
    with an empty-string key for the market's default provider.
    A non-positive resolved bandwidth means "not modeled": the
    transfer is instantaneous, matching pre-comms behavior.
    """

    def __init__(self, providers: Dict[str, Tuple[float, Dict[str, float]]]):
        self._providers = dict(providers)

    @classmethod
    def from_market(cls, market: Any) -> "UplinkChannel":
        """Lift every provider's uplink fields off a `SpotMarket`
        (duck-typed: anything with `.providers` name->descriptor)."""
        table: Dict[str, Tuple[float, Dict[str, float]]] = {}
        for name, prov in getattr(market, "providers", {}).items():
            base = float(getattr(prov, "uplink_mbps", 0.0))
            zones = {z: float(mbps)
                     for z, mbps in getattr(prov, "zone_uplink_mbps", ())}
            table[name] = (base, zones)
        if table:
            table.setdefault("", next(iter(table.values())))
        return cls(table)

    def uplink_mbps(self, provider: str = "",
                    zone: str = "") -> float:
        """Resolved uplink bandwidth (Mbit/s): the zone override when
        present, else the provider base; 0.0 when unmodeled."""
        base, zones = self._providers.get(provider or "",
                                          self._providers.get("", (0.0, {})))
        return zones.get(zone, base)

    def transfer_s(self, payload_bytes: int, provider: str = "",
                   zone: str = "") -> float:
        """Seconds `payload_bytes` occupies the client's uplink; 0.0
        when bandwidth is unmodeled (instantaneous upload)."""
        mbps = self.uplink_mbps(provider, zone)
        if mbps <= 0.0 or payload_bytes <= 0:
            return 0.0
        return payload_bytes * 8.0 / (mbps * 1e6)


class CommsModel:
    """One run's communication model: payload size + uplink channel.

    Engines call `transfer_s(provider, zone)` when a client finishes
    local training and stretch round completion by the result; the
    matching `ClientUpdateSent` event carries `size_mb`/`quantized` so
    the accountant can price egress.
    """

    def __init__(self, payload: UpdatePayload, channel: UplinkChannel):
        self.payload = payload
        self.channel = channel

    @property
    def size_mb(self) -> float:
        """Wire size (MB) of one client update."""
        return self.payload.size_mb

    @property
    def quantized(self) -> bool:
        """Whether updates travel in the grad_quant int8 layout."""
        return self.payload.quantized

    def transfer_s(self, provider: str = "", zone: str = "") -> float:
        """Upload duration for one update from (provider, zone)."""
        return self.channel.transfer_s(self.payload.num_bytes,
                                       provider, zone)
