"""Real spot-market trace ingestion: price histories and recorded
interruptions.

Price histories are the format `aws ec2 describe-spot-price-history`
exports — CSV with a header row

    Timestamp,AvailabilityZone,InstanceType,ProductDescription,SpotPrice
    2024-03-01T00:00:00Z,us-east-1a,g5.xlarge,Linux/UNIX,0.3872

or JSONL with the same keys per line — and build one piecewise-constant
`TracePriceSource` per availability zone. Timestamps become seconds
relative to the earliest record in the file (the "market epoch"), so a
replayed market day starts at simulated t=0 regardless of when the
history was captured.

Interruption traces are the same shape minus the price column
(`Timestamp,AvailabilityZone,InstanceType`), one row per observed spot
reclaim; files are conventionally named `<provider>.interruptions.csv`
(or `.jsonl`) and live alongside the price histories so both replay on
one shared market clock. `build_interruption_schedule` turns them into
per-zone ascending timestamp lists for the replay preemption model
(`repro_torch.cloud.preemption.ReplayInterruptionModel`).

Malformed rows raise `TraceFormatError` carrying the file and line
number; the CI fixture-validation step runs this module as

    python -m repro_torch.cloud.traces --validate tests/fixtures/prices

which routes `*.interruptions.*` files through the interruption parser
and everything else through the price parser.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import sys
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.cloud.pricing import TracePriceSource, Zone

CSV_COLUMNS = ("Timestamp", "AvailabilityZone", "InstanceType",
               "ProductDescription", "SpotPrice")
INTERRUPTION_COLUMNS = ("Timestamp", "AvailabilityZone", "InstanceType")


class TraceFormatError(ValueError):
    """A trace file row failed to parse; the message carries
    `<file>:<line>` so CI output points at the offending record."""


@dataclasses.dataclass(frozen=True)
class PriceRecord:
    """One parsed spot-price-history row."""
    timestamp: float                # absolute epoch seconds (UTC)
    zone: str
    instance_type: str
    product: str
    price: float


def _parse_timestamp(raw: str, where: str) -> float:
    try:
        dt = datetime.fromisoformat(raw.replace("Z", "+00:00"))
    except ValueError:
        raise TraceFormatError(f"{where}: bad timestamp {raw!r}")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def _parse_price(raw: str, where: str) -> float:
    try:
        price = float(raw)
    except (TypeError, ValueError):
        raise TraceFormatError(f"{where}: bad price {raw!r}")
    if not price >= 0.0:            # also catches NaN
        raise TraceFormatError(f"{where}: negative price {raw!r}")
    return price


def _record_from_fields(fields: Dict[str, str], where: str) -> PriceRecord:
    missing = [c for c in CSV_COLUMNS if not fields.get(c)]
    if missing:
        raise TraceFormatError(f"{where}: missing field(s) {missing}")
    return PriceRecord(
        timestamp=_parse_timestamp(fields["Timestamp"], where),
        zone=fields["AvailabilityZone"],
        instance_type=fields["InstanceType"],
        product=fields["ProductDescription"],
        price=_parse_price(fields["SpotPrice"], where))


def _iter_rows(path: Path, columns: Tuple[str, ...]):
    """Yield `(fields, where)` per data row of a CSV (strict header) or
    JSONL trace file, raising `TraceFormatError` on structural
    problems. Shared by the price and interruption parsers."""
    if path.suffix.lower() == ".jsonl":
        for i, line in enumerate(path.read_text().splitlines(), start=1):
            if not line.strip():
                continue
            where = f"{path.name}:{i}"
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceFormatError(f"{where}: bad JSON ({e.msg})")
            if not isinstance(obj, dict):
                raise TraceFormatError(f"{where}: expected an object")
            yield ({c: str(obj[c]) if c in obj else "" for c in columns},
                   where)
    else:
        with path.open(newline="") as fh:
            reader = csv.reader(fh)
            header = next(reader, None)
            if header is None or tuple(h.strip() for h in header) != \
                    columns:
                raise TraceFormatError(
                    f"{path.name}:1: bad header {header!r}, expected "
                    f"{','.join(columns)}")
            for i, row in enumerate(reader, start=2):
                if not row:
                    continue
                where = f"{path.name}:{i}"
                if len(row) != len(columns):
                    raise TraceFormatError(
                        f"{where}: {len(row)} column(s), expected "
                        f"{len(columns)}")
                yield dict(zip(columns, (c.strip() for c in row))), where


def parse_price_file(path: Union[str, Path]) -> List[PriceRecord]:
    """Parse one CSV or JSONL spot-history file into records (sorted by
    timestamp). Raises `TraceFormatError` on any malformed row."""
    path = Path(path)
    records = [_record_from_fields(fields, where)
               for fields, where in _iter_rows(path, CSV_COLUMNS)]
    if not records:
        raise TraceFormatError(f"{path.name}: no price records")
    records.sort(key=lambda r: (r.timestamp, r.zone))
    return records


@dataclasses.dataclass(frozen=True)
class InterruptionRecord:
    """One observed spot reclaim: when and in which zone."""
    timestamp: float                # absolute epoch seconds (UTC)
    zone: str
    instance_type: str


def parse_interruption_file(
        path: Union[str, Path]) -> List[InterruptionRecord]:
    """Parse one CSV or JSONL recorded-interruption file (the
    spot-history format minus the price/product columns) into records
    sorted by timestamp. Raises `TraceFormatError` on malformed rows."""
    path = Path(path)
    records: List[InterruptionRecord] = []
    for fields, where in _iter_rows(path, INTERRUPTION_COLUMNS):
        missing = [c for c in INTERRUPTION_COLUMNS if not fields.get(c)]
        if missing:
            raise TraceFormatError(f"{where}: missing field(s) {missing}")
        records.append(InterruptionRecord(
            timestamp=_parse_timestamp(fields["Timestamp"], where),
            zone=fields["AvailabilityZone"],
            instance_type=fields["InstanceType"]))
    if not records:
        raise TraceFormatError(f"{path.name}: no interruption records")
    records.sort(key=lambda r: (r.timestamp, r.zone))
    return records


def build_interruption_schedule(records: Sequence[InterruptionRecord],
                                epoch: Optional[float] = None,
                                instance_type: Optional[str] = None,
                                ) -> Dict[str, Tuple[float, ...]]:
    """Zone -> ascending interruption times in market-clock seconds.

    `epoch` should be the owning market's epoch (earliest price record
    across its trace files) so the reclaim times line up with the price
    replay; it defaults to the earliest interruption when the schedule
    stands alone."""
    if instance_type is not None:
        records = [r for r in records if r.instance_type == instance_type]
    if not records:
        raise TraceFormatError(
            "no interruption records"
            + (f" for instance type {instance_type!r}"
               if instance_type is not None else ""))
    t0 = epoch if epoch is not None else min(r.timestamp for r in records)
    by_zone: Dict[str, List[float]] = {}
    for r in records:
        by_zone.setdefault(r.zone, []).append(r.timestamp - t0)
    return {z: tuple(sorted(ts)) for z, ts in by_zone.items()}


def _region_of(zone: str) -> str:
    """AWS-style zone -> region: strip the trailing zone letter
    ("us-east-1a" -> "us-east-1"); GCP-style "us-central1-a" loses the
    "-a" suffix."""
    if len(zone) > 2 and zone[-2] == "-":
        return zone[:-2]
    return zone[:-1] if zone and zone[-1].isalpha() else zone


def build_zone_sources(records: Sequence[PriceRecord],
                       provider: str = "aws",
                       instance_type: Optional[str] = None,
                       epoch: Optional[float] = None,
                       ) -> List[Tuple[Zone, TracePriceSource]]:
    """Build `(Zone, TracePriceSource)` pairs from already-parsed
    records (one parse can feed several consumers — epoch computation
    and source construction).

    Zones are emitted sorted by name (deterministic market registration
    order). `epoch` overrides the t=0 reference (default: the records'
    earliest timestamp) so multiple providers' traces can share one
    market clock."""
    if instance_type is not None:
        records = [r for r in records if r.instance_type == instance_type]
    if not records:
        raise TraceFormatError(
            f"no price records"
            + (f" for instance type {instance_type!r}"
               if instance_type is not None else ""))
    t0 = epoch if epoch is not None else min(r.timestamp for r in records)
    by_zone: Dict[str, List[PriceRecord]] = {}
    for r in records:
        by_zone.setdefault(r.zone, []).append(r)
    out = []
    for zone_name in sorted(by_zone):
        zrecs = by_zone[zone_name]
        out.append((Zone(zone_name, _region_of(zone_name), provider),
                    TracePriceSource([r.timestamp - t0 for r in zrecs],
                                     [r.price for r in zrecs])))
    return out


def load_price_trace(path: Union[str, Path],
                     provider: str = "aws",
                     instance_type: Optional[str] = None,
                     epoch: Optional[float] = None,
                     ) -> List[Tuple[Zone, TracePriceSource]]:
    """`build_zone_sources` over one freshly parsed history file."""
    return build_zone_sources(parse_price_file(path), provider,
                              instance_type, epoch)


def shared_epoch(paths: Sequence[Union[str, Path]]) -> float:
    """Earliest timestamp across several history files — the common
    market epoch for a multi-provider trace-driven run."""
    return min(min(r.timestamp for r in parse_price_file(p))
               for p in paths)


# ---------------------------------------------------------------------------
# Fixture validation (CI).
# ---------------------------------------------------------------------------
def is_interruption_trace(path: Union[str, Path]) -> bool:
    """File-name convention: `<provider>.interruptions.csv` / `.jsonl`
    holds recorded reclaims; everything else is a price history."""
    stem = Path(path).stem          # drops only the final suffix
    return stem.endswith(".interruptions")


def validate_dir(directory: Union[str, Path]) -> List[str]:
    """Parse every *.csv / *.jsonl under `directory` — price histories
    and `*.interruptions.*` reclaim records; returns a summary line per
    file, raises `TraceFormatError` on the first bad row."""
    directory = Path(directory)
    paths = sorted(list(directory.glob("*.csv"))
                   + list(directory.glob("*.jsonl")))
    if not paths:
        raise TraceFormatError(f"no trace files under {directory}")
    lines = []
    for p in paths:
        if is_interruption_trace(p):
            irecords = parse_interruption_file(p)
            zones = sorted({r.zone for r in irecords})
            lines.append(f"{p.name}: {len(irecords)} interruptions, "
                         f"{len(zones)} zones ({', '.join(zones)})")
            continue
        records = parse_price_file(p)
        zones = sorted({r.zone for r in records})
        span_h = (max(r.timestamp for r in records)
                  - min(r.timestamp for r in records)) / 3600.0
        lines.append(f"{p.name}: {len(records)} records, "
                     f"{len(zones)} zones ({', '.join(zones)}), "
                     f"{span_h:.1f}h span")
    return lines


def main(argv=None) -> int:
    """CLI entry point: `python -m repro_torch.cloud.traces --validate DIR`."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--validate", metavar="DIR", required=True,
                    help="parse every *.csv / *.jsonl under DIR; exit "
                         "non-zero on any malformed row")
    args = ap.parse_args(argv)
    try:
        for line in validate_dir(args.validate):
            print(line)
    except TraceFormatError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
