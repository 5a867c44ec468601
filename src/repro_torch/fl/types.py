"""The trainer attachment interface: a copy of the JAX package's
`fl/types.py::TrainerHooks`, the protocol the FL round engines drive."""
from __future__ import annotations

from typing import Dict, List, Optional


class TrainerHooks:
    """Optional attachment for real model training."""

    def run_local(self, client: str, round_idx: int) -> None:  # pragma: no cover
        """Execute the client's local training for `round_idx` (called
        at the simulated completion instant of the epoch)."""
        pass

    def aggregate(self, participants: List[str], round_idx: int,
                  staleness: Optional[Dict[str, int]] = None) -> None:  # pragma: no cover
        """Fold the participants' buffered updates into the global model.

        `staleness` maps each participant to the number of aggregation
        rounds that fired between its dispatch and this aggregation
        (always 0 under the synchronous barrier; FedBuff-style async
        engines report how stale each buffered update is so the
        implementation can discount it, e.g. by 1/sqrt(1+staleness)).
        """
        pass

    def update_payload(self, quantized: bool = False):  # pragma: no cover
        """The wire size of one client update these hooks produce, as a
        `repro_torch.comms.payload.UpdatePayload` — or None when the
        hooks have no real parameters to size (the default)."""
        return None
