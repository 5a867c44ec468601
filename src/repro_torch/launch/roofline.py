"""Roofline analysis of the port: the step-time estimate that
`fl/training.py::calibrate` holds a measured round against, the work
counts of the port's hand-written kernels, `WorkCounter`, which counts
the FLOPs and bytes of a stretch of PyTorch code, the kernels' launches
included, and the dry run's three-term roofline (`analyze`) with the
model-FLOPs yardstick (`model_flops`).

Counterpart of the JAX package's `launch/roofline.py` and of its
`launch/hlo_analysis.py`, which the port does not copy. The JAX package
reads a step's FLOPs and bytes from the compiled HLO, weighting each
`while` body (the scan over layers) by its trip count. PyTorch runs
eagerly, so the port counts what runs, on the card or on the meta
device (the dry run, `launch/dryrun.py`), where the Python loop over the
layers stands in for the scan's trip count:
  FLOPs  `torch.utils.flop_counter.FlopCounterMode` (matrix products);
  bytes  a dispatch mode that sums each aten op's input and output bytes,
         the analogue of XLA's `bytes accessed` (views and allocations
         move nothing and count nothing).
The kernels launch through `ctypes`, which neither mode sees, so each
kernel wrapper adds its own work (`add_kernel_work`, with the formulas
below) where it counts its launch, or, on a meta tensor, where it would
launch. On a CPU tensor a wrapper runs its plain version, whose aten ops
the modes count themselves.

The peaks are always the caller's, measured on the device
(`fl/training.py::_measure_peaks`) or named on the dry run's command
line: this module holds no hardware constant.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


def estimate_step_time(flops: float, bytes_accessed: float, *,
                       peak_flops: float, hbm_bw: float,
                       combine: str = "max") -> float:
    """Roofline wall-clock estimate for one step from its FLOP and byte
    counts, against the peaks the caller measured.

    `combine="max"` is the classic roofline bound (terms overlap);
    `"sum"` models a serial host where compute and memory traffic share
    one pipe, the estimate `calibrate` reports.
    """
    if not (peak_flops > 0 and hbm_bw > 0):
        raise ValueError(f"estimate_step_time: peaks must be measured and "
                         f"positive, got {peak_flops} FLOP/s, {hbm_bw} B/s")
    compute_s = flops / peak_flops
    memory_s = bytes_accessed / hbm_bw
    if combine == "sum":
        return compute_s + memory_s
    return max(compute_s, memory_s)


# ---------------------------------------------------------------------------
# The kernels' work: (FLOPs, bytes) of one launch. Bytes count each input
# read once and each output written once.
# ---------------------------------------------------------------------------
def attention_work(B, S, T, N, H, elem_bytes, *, causal=True, window=None):
    """The flash forward's work: q, k, v read, o written; the
    multiply-adds of QK^T and PV over the (query, key) pairs that the
    mask of `kernels/flash_attention/ref.py` leaves (causal: key j <= query
    i; a window: j > i - window)."""
    pairs = 0
    for i in range(S):
        hi = min(i, T - 1) if causal else T - 1
        lo = max(0, i - window + 1) if window else 0
        pairs += max(hi - lo + 1, 0)
    return 4.0 * H * pairs * B * N, 2 * (S + T) * B * N * H * elem_bytes


def ssd_flops(b, s, h, p, n, chunk):
    """The chunked form's products, per chunk of Q rows: C B^T and (.)x
    over the Q(Q+1)/2 causal pairs (j <= i) only, C . state and the
    state update. The function does not depend on the chunk, and fewer
    rows a chunk take fewer products: pass the smallest chunk that a
    kernel of the function is known to run at."""
    flops = 0.0
    for t0 in range(0, s, chunk):
        q = min(chunk, s - t0)
        flops += 2.0 * (q * (q + 1) // 2) * (n + p) + 4.0 * q * n * p
    return flops * b * h


def ssd_work(b, s, h, p, g, n, chunk, elem_bytes):
    """The ssd forward's work: x read and y written, the fp32 log decay,
    one group's B and C read once."""
    return (ssd_flops(b, s, h, p, n, chunk),
            2 * b * s * h * p * elem_bytes + b * s * h * 4
            + 2 * b * s * g * n * elem_bytes)


def rglru_work(n, backward=False):
    """The RG-LRU scan's work over n fp32 elements: forward (and reverse)
    read la and the input and write the output, one fused multiply-add a
    step; the fused backward reads la, gh and h and writes dlog_a and db,
    a fused multiply-add and two multiplies a step."""
    if backward:
        return 4.0 * n, 5 * n * 4
    return 2.0 * n, 3 * n * 4


def codec_work(n, n_blocks, block, dequantize=False):
    """The int8 codec's work over n fp32 elements in `n_blocks` rows of
    `block`: the fp32 values, the int8 rows and the fp32 scales, each
    once. Quantize: abs and max, then a divide, a round and two clamps
    an element, and one reciprocal a row; dequantize: one multiply."""
    nbytes = 4 * n + n_blocks * block + 4 * n_blocks
    return (1.0 * n if dequantize else 5.0 * n + n_blocks), nbytes


# ---------------------------------------------------------------------------
# Counting.
# ---------------------------------------------------------------------------
_ACTIVE: List["WorkCounter"] = []

_ATEN = torch.ops.aten
# allocations, and a view that its schema does not mark as one: no data
# moves
_NO_TRAFFIC = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
               _ATEN.empty_like.default, _ATEN.new_empty.default,
               _ATEN.new_empty_strided.default, _ATEN._unsafe_view.default}
# their first argument is only written, never read
_WRITE_ONLY = {_ATEN.copy_.default, _ATEN.fill_.Scalar, _ATEN.zero_.default}


def _is_view(func) -> bool:
    """An op whose output aliases an input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _ByteMode(TorchDispatchMode):
    """Sums every aten op's input and output bytes, by op."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _NO_TRAFFIC or _is_view(func):
            return out
        ins = args[1:] if func in _WRITE_ONLY else args
        n = sum(t.nbytes for t in tree_leaves((ins, kwargs, out))
                if isinstance(t, torch.Tensor))
        self.by_op[func.overloadpacket.__name__] += n
        return out


class WorkCounter:
    """FLOPs and bytes of the PyTorch code run inside `with WorkCounter()`,
    the port's kernels included:

        with WorkCounter() as wc:
            hooks._local_train(...)
        wc.flops, wc.bytes_accessed

    `aten_flops`/`aten_bytes` are what the dispatch modes saw; `kernels`
    maps each kernel wrapper to [launches, FLOPs, bytes] added in it."""

    def __init__(self):
        self.kernels: Dict[str, List[float]] = {}
        self.bytes_by_op: Dict[str, int] = {}
        self.aten_flops = 0.0
        self.aten_bytes = 0.0
        self._modes: Tuple = ()

    def __enter__(self) -> "WorkCounter":
        self._modes = (FlopCounterMode(display=False), _ByteMode())
        for m in self._modes:
            m.__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        flop_mode, byte_mode = self._modes
        byte_mode.__exit__(*exc)
        flop_mode.__exit__(*exc)
        self.aten_flops = float(flop_mode.get_total_flops())
        self.bytes_by_op = dict(byte_mode.by_op)
        self.aten_bytes = float(sum(self.bytes_by_op.values()))
        return False

    @property
    def kernel_flops(self) -> float:
        return float(sum(k[1] for k in self.kernels.values()))

    @property
    def kernel_bytes(self) -> float:
        return float(sum(k[2] for k in self.kernels.values()))

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernel_flops

    @property
    def bytes_accessed(self) -> float:
        return self.aten_bytes + self.kernel_bytes


def add_kernel_work(name: str,
                    work: Callable[[], Tuple[float, float]]) -> None:
    """Add one launch of kernel `name` and its (FLOPs, bytes), as
    `work()` gives them, to every active `WorkCounter`. Kernel wrappers
    call this where they count a launch; `work` is only evaluated while
    a counter is active."""
    if not _ACTIVE:
        return
    flops, nbytes = work()
    for wc in _ACTIVE:
        k = wc.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += float(flops)
        k[2] += float(nbytes)


# ---------------------------------------------------------------------------
# The dry run's roofline.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CollectiveStats:
    """Bytes and calls of each collective kind, as the code that runs
    the collective counts them (`fl/mesh_fl.py`'s int8 ring), where the
    JAX package parses them out of the compiled HLO."""
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device (HBM traffic proxy)
    collective_bytes: float      # per device
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float           # 6ND / 2ND useful work (whole step, global)
    useful_ratio: float          # model_flops / (flops * chips)
    peak_fraction: float         # compute_s / max(all terms)
    collective_by_kind: Optional[Dict[str, float]] = None

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(counter: WorkCounter, *, n_chips: int, model_flops_global: float,
            peak_flops: float, hbm_bw: float, link_bw: Optional[float] = None,
            collective_bytes: Optional[CollectiveStats] = None) -> Roofline:
    """The three roofline terms of a counted run on one device:
    `counter`'s FLOPs over `peak_flops`, its bytes over `hbm_bw`, and the
    collective bytes a device moves over `link_bw` (0 without
    collectives; a link rate is needed only with them). The peaks are
    the caller's, measured on the device or taken from a data sheet."""
    if not (peak_flops > 0 and hbm_bw > 0):
        raise ValueError(f"analyze: peaks must be positive, got "
                         f"{peak_flops} FLOP/s, {hbm_bw} B/s")
    flops, nbytes = counter.flops, counter.bytes_accessed
    coll = float(collective_bytes.total_bytes) if collective_bytes else 0.0
    if coll and not (link_bw and link_bw > 0):
        raise ValueError("analyze: collective bytes need a positive link_bw")
    compute_s = flops / peak_flops
    memory_s = nbytes / hbm_bw
    collective_s = coll / link_bw if coll else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_device_flops = flops * n_chips
    useful = (model_flops_global / total_device_flops
              if total_device_flops else 0.0)
    bound = max(terms.values())
    return Roofline(
        flops=flops, bytes_accessed=nbytes, collective_bytes=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops_global,
        useful_ratio=useful,
        peak_fraction=(compute_s / bound) if bound > 0 else 0.0,
        collective_by_kind=({k: float(v) for k, v in
                             collective_bytes.bytes_by_kind.items() if v}
                            if collective_bytes else {}))


# ---------------------------------------------------------------------------
# Model-FLOPs (the "useful work" yardstick).
# ---------------------------------------------------------------------------
def active_param_count(cfg) -> float:
    """Params touched per token: MoE expert weights scale by top_k/E."""
    from repro_torch.models import lm
    total = 0.0
    for keys, (shape, _) in lm.param_shapes(cfg):
        n = float(math.prod(shape))
        if cfg.moe is not None and any(
                k in keys for k in ("wi_gate", "wi_up", "wi", "wo")) \
                and "mlp" in keys:
            n *= cfg.moe.top_k / cfg.moe.num_experts
        total += n
    return total


def model_flops(cfg, shape) -> float:
    """6·N·D train / 2·N·D forward; D = tokens processed by the step."""
    n = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
