"""Communication-cost subsystem: what a client update *costs* to send.

FedCostAware priced compute seconds but never the client→server
transfer, which Multi-FedLS (Brum et al., 2023) shows is a first-order
cost term in real cross-silo multi-cloud FL. This package models it in
three separable pieces:

  payload.py — how many bytes one client update is, sized from the
               actual param pytree (fp32 baseline, or the grad_quant
               int8 block layout when updates are quantized)
  channel.py — how long the upload occupies the client's uplink
               (per-provider / per-zone bandwidth), which is what
               extends round makespan inside both engines
  billing.py — what the egress costs in dollars (`TransferRates`,
               extending the `StorageRates` pattern), priced by the
               live `CostAccountant` into `TransferBilled` events

Everything is opt-in and zero-defaulted: a run without
`FLRunConfig.update_payload_mb` (or payload-exposing trainer hooks)
publishes no comms events and bills no transfer dollars, so every
pre-comms event stream and golden total is unchanged.
"""
from repro_torch.comms.billing import TransferRates
from repro_torch.comms.channel import CommsModel, UplinkChannel
from repro_torch.comms.payload import UpdatePayload, fp32_leaf_bytes, \
    quantized_leaf_bytes

__all__ = ["CommsModel", "TransferRates", "UpdatePayload", "UplinkChannel",
           "fp32_leaf_bytes", "quantized_leaf_bytes"]
