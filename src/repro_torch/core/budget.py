"""Budget adherence (paper §III-E).

Each client declares a maximum budget; a ledger tracks real-time spend
(the paper's "background monitoring process"). Before each round the
scheduler checks `remaining >= estimated next-round cost` and excludes
clients that cannot afford the round — from that round *and all
subsequent rounds*.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Set


@dataclasses.dataclass
class BudgetEntry:
    budget: float
    spent: float = 0.0
    excluded: bool = False

    @property
    def remaining(self) -> float:
        return self.budget - self.spent


class BudgetLedger:
    def __init__(self):
        self._entries: Dict[str, BudgetEntry] = {}

    def register(self, client: str, budget: float):
        self._entries[client] = BudgetEntry(budget)

    def sync_spend(self, client: str, total_spent: float):
        """Update from the cloud's authoritative accrued cost."""
        self._entries[client].spent = total_spent

    def remaining(self, client: str) -> float:
        return self._entries[client].remaining

    def is_excluded(self, client: str) -> bool:
        return self._entries[client].excluded

    def exclude(self, client: str):
        self._entries[client].excluded = True

    def affordable(self, client: str, est_round_cost: float) -> bool:
        return self._entries[client].remaining >= est_round_cost

    def screen_round(self, clients: List[str],
                     est_round_cost: Callable[[str], float]) -> List[str]:
        """Return participants; permanently exclude the rest (§III-E)."""
        keep = []
        for c in clients:
            if self.is_excluded(c):
                continue
            if self.affordable(c, est_round_cost(c)):
                keep.append(c)
            else:
                self.exclude(c)
        return keep
