"""Model configuration for the PyTorch port.

Copies of `MoEConfig`, `SSMConfig`, `RGLRUConfig` and `ModelConfig` from
the JAX package's `common/config.py`, kept here because the port imports
nothing from that package. Field names and derived properties are the
same, so a config reads alike in both; `activation_dtype` and
`param_torch_dtype` give torch dtypes.

The FL and cloud configs below them (`ClientProfile` through
`FLRunConfig`, what the simulator, the scheduler and the runner read)
are copied unchanged.

Fields that only steer the JAX package's TPU path are left out:
`use_pallas` (the port always runs its kernels on the card),
`attn_chunk` (the chunked-attention fallback is not ported) and
`scan_layers`. `grad_accum` steers `launch/steps.py::make_train_step`,
as in the JAX package. `sharding_overrides` feeds the sharding rules
(`sharding/rules.py`), which resolve the specs the dry run reports;
nothing of the port shards a tensor by them.

`ShapeConfig` and `SHAPES`, the input shapes of the dry run's cells,
are copies too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Layer kinds used in block patterns.
# ---------------------------------------------------------------------------
ATTN = "attn"            # global self attention (GQA / MHA)
LOCAL_ATTN = "local_attn"  # sliding-window self attention
CROSS_ATTN = "cross_attn"  # cross attention to (stub) image embeddings
MAMBA2 = "mamba2"        # SSD state-space layer
RGLRU = "rglru"          # Griffin recurrent block (RG-LRU)

SUPPORTED_KINDS = (ATTN, LOCAL_ATTN, CROSS_ATTN, MAMBA2, RGLRU)

# float64 serves numerics checks on the CPU (tools/lm_fp32_spread.py)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    group_size: int = 512          # tokens per dispatch group (GShard style)
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD hyper-parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """Griffin / RecurrentGemma recurrent-block hyper-parameters."""
    lru_width: Optional[int] = None   # defaults to d_model
    conv_width: int = 4
    c_constant: float = 8.0           # the fixed `c` exponent scale


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype for a config dtype string ("float32", "bfloat16",
    "float64")."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {list(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|ssm|hybrid|moe|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    # Block pattern. A model is `num_layers` layers tiled by `pattern`;
    # remainder layers (num_layers % len(pattern)) form an explicit tail
    # taking the pattern prefix.
    pattern: Tuple[str, ...] = (ATTN,)
    # attention
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    window_size: int = 2048            # for local_attn layers
    logit_softcap: Optional[float] = None
    # mlp
    mlp_kind: str = "swiglu"           # swiglu|gelu
    # optional sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # vlm / audio frontends (stub): number of conditioning tokens fed to
    # cross-attention layers (vlm) or raw frame-embedding inputs (audio).
    n_cond_tokens: int = 0
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    grad_accum: int = 1                # microbatches per train step
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    # per-arch logical->mesh rule overrides (e.g. granite's 40 experts do
    # not divide a 16-way axis: shard the expert FFN dim instead)
    sharding_overrides: Optional[Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...]] = None

    # ------------------------------------------------------------------
    def __post_init__(self):
        for k in self.pattern:
            if k not in SUPPORTED_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")
        if self.family == "moe" and self.moe is None:
            raise ValueError("moe family requires MoEConfig")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def n_super(self) -> int:
        """Number of full pattern repetitions (the stacked blocks)."""
        return self.num_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        """Remainder layers appended after the stacked super-blocks."""
        return self.pattern[: self.num_layers % len(self.pattern)]

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def is_subquadratic(self) -> bool:
        """True when no layer performs global attention (long_500k eligible)."""
        full = set(self.pattern + self.tail_pattern)
        return ATTN not in full and CROSS_ATTN not in full


# ---------------------------------------------------------------------------
# Input shapes (the assigned 4-shape set).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# FL / cloud configuration (the paper's experiments).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ClientProfile:
    """Per-client heterogeneity profile used by the simulator."""
    name: str
    mean_epoch_s: float            # warm per-epoch wall time
    cold_multiplier: float = 1.15  # first-epoch-on-fresh-instance slowdown
    jitter: float = 0.03           # lognormal sigma on epoch time
    budget: float = float("inf")   # USD
    n_samples: int = 1             # FedAvg weight
    zone: Optional[str] = None     # pinned zone, else cheapest
    provider: Optional[str] = None  # provider of the pinned zone
    join_round: int = 0            # elastic scaling: round the client joins


@dataclasses.dataclass(frozen=True)
class ProviderConfig:
    """One provider's market + billing parameters inside a
    `MarketConfig`. `price_trace` switches the provider's zones from the
    synthetic OU process to real recorded spot history (a CSV/JSONL file
    in AWS spot-price-history format, see `repro_torch.cloud.traces`)."""
    name: str = "aws"
    on_demand_rate: float = 1.008
    spot_rate_mean: float = 0.3951
    spot_rate_sigma: float = 0.004
    n_zones: int = 4
    regions: Tuple[str, ...] = ("us-east-1", "us-east-2", "us-west-2",
                                "eu-west-1")
    billing_granularity_s: float = 1.0
    min_billing_s: float = 60.0
    preemption_notice_s: float = 0.0
    price_trace: Optional[str] = None
    # price-coupled preemption (cloud.preemption.PriceCoupledModel):
    # hazard multiplier slope vs the zone's mean price. 0 decouples the
    # provider's reclaim rate from its price level entirely.
    preemption_price_sensitivity: float = 1.0
    # recorded real interruption timestamps for this provider's zones
    # (cloud.preemption.ReplayInterruptionModel); a CSV/JSONL file in
    # the spot-history format minus the price column, sharing the
    # market epoch with `price_trace` (see `repro_torch.cloud.traces`)
    interruption_trace: Optional[str] = None
    # object-storage rates (`repro_torch.cloud.pricing.StorageRates`) billed
    # per warning-window checkpoint write: a flat PUT-request charge
    # plus per-MB egress of the model state
    # (`SchedulerConfig.warning_ckpt_size_mb`). Zero by default, so
    # checkpoint writes stay free unless a market opts in.
    storage_put_usd: float = 0.0
    storage_egress_usd_per_mb: float = 0.0
    # client-update egress rate (`repro_torch.cloud.pricing.TransferRates`,
    # the comms subsystem): dollars per MB a client's model update
    # costs to leave this provider on its way to the aggregation
    # server. Zero by default — per-round transfer dollars only appear
    # when a market opts in, keeping every pre-comms total unchanged.
    update_egress_usd_per_mb: float = 0.0
    # uplink bandwidth (megabits/s) of this provider's instances toward
    # the aggregation server; client-update transfers occupy the client
    # for payload_bits / uplink for this long, extending the round
    # makespan inside both engines. <= 0 models an instantaneous
    # uplink (no makespan extension — the pre-comms behavior).
    uplink_mbps: float = 0.0
    # per-zone uplink overrides as ("zone-name", mbps) pairs; zones
    # absent here fall back to `uplink_mbps`
    zone_uplink_mbps: Tuple[Tuple[str, float], ...] = ()


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One adversarial market scenario applied on top of a
    `MarketConfig`'s base price processes (`repro_torch.cloud.scenarios`).

    `name` selects the generator from the scenario registry
    ("flash_crash" | "capacity_crunch" | "diurnal" |
    "price_inversion"); every generator is fully seeded, so the same
    (market, scenario) pair always produces byte-identical traces and
    reclaim schedules. `strength` scales the stress (1.0 = the
    generator's documented default severity), `horizon_s`/`step_s` the
    shaped trace's extent and resolution, and `provider` flags which
    provider the scenario squeezes (capacity_crunch / price_inversion;
    None = the market's first provider)."""
    name: str
    seed: int = 0
    horizon_s: float = 48 * 3600.0
    step_s: float = 300.0
    strength: float = 1.0
    provider: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MarketConfig:
    """The spot market a run executes against: one or more providers,
    each synthetic or trace-driven. Provider order is placement
    tie-break order (see `SpotMarket.cheapest_zone`). `scenario`
    optionally reshapes the built market through a seeded adversarial
    generator (`repro_torch.cloud.scenarios`) — flash crashes, correlated
    capacity-crunch reclaims, diurnal cycles, cross-provider price
    inversions — registered by name so every benchmark can request a
    stress market by configuration alone."""
    providers: Tuple[ProviderConfig, ...] = (ProviderConfig(),)
    scenario: Optional[ScenarioConfig] = None


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """A large client population described by distribution parameters
    instead of per-client `ClientProfile` objects (the cross-silo ->
    cross-device jump).

    The fleet core (`repro_torch.cloud.fleet.ClientArrays`) expands this into
    contiguous numpy arrays in O(arrays) — constructing a 100k-client
    run never materializes 100k Python objects. Per-client warm epoch
    times are lognormal around `mean_epoch_s` with cross-client sigma
    `epoch_sigma` (0 makes the population homogeneous), drawn from
    `seed` so a population is reproducible independent of the run
    seed."""
    n_clients: int
    mean_epoch_s: float = 900.0
    epoch_sigma: float = 0.25      # cross-client lognormal spread
    cold_multiplier: float = 1.15
    jitter: float = 0.03           # per-epoch lognormal sigma (per run)
    budget: float = float("inf")   # USD, uniform across the population
    name_prefix: str = "c"         # client i is f"{name_prefix}{i}"
    seed: int = 0                  # population draw seed

    def __post_init__(self):
        if self.n_clients <= 0:
            raise ValueError("population needs n_clients >= 1")


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    on_demand_rate: float = 1.008        # $/hr g5.xlarge (paper Table I)
    spot_rate_mean: float = 0.3951       # $/hr
    spot_rate_sigma: float = 0.004       # zone-to-zone / temporal wiggle
    n_zones: int = 4
    spin_up_mean_s: float = 150.0        # instance provisioning + boot
    spin_up_sigma: float = 0.10
    preemption_rate_per_hr: float = 0.0  # paper observed none; configurable
    # which `repro_torch.cloud.preemption.PreemptionModel` reclaims spot
    # instances: "constant" (flat Poisson at `preemption_rate_per_hr`,
    # bit-identical to the pre-model behavior), "price_coupled" (hazard
    # scales with the zone's current spot price level), "replay"
    # (recorded interruption timestamps from the providers'
    # `interruption_trace` files), or "correlated" (constant-rate
    # background churn plus the market's scheduled reclaims — e.g. the
    # `capacity_crunch` scenario's provider-wide correlated hits)
    preemption_model: str = "constant"
    # sensitivity of the legacy single-provider synthetic market under
    # the price-coupled model (multi-provider markets carry it per
    # provider in `ProviderConfig.preemption_price_sensitivity`)
    preemption_price_sensitivity: float = 1.0
    billing_granularity_s: float = 1.0   # per-second billing
    min_billing_s: float = 60.0          # AWS bills min 60s for spot
    # explicit multi-provider / trace-driven market; None keeps the
    # legacy single-provider synthetic market built from the scalar
    # fields above (bit-identical to the pre-SpotMarket behavior)
    market: Optional[MarketConfig] = None
    # fleets at or above this many clients switch from the per-object
    # simulator hot path (one heap callback per instance, per-instance
    # events — bit-identical to every pre-fleet release) to the
    # struct-of-arrays fleet core (`repro_torch.cloud.fleet`), which batches
    # spin-ups, billing and preemption draws per round and publishes
    # aggregate `FleetStepSummary` events instead of the per-instance
    # vocabulary. `FLRunConfig.fleet` overrides the switch per run.
    fleet_threshold: int = 512


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """FedCostAware knobs (paper §III)."""
    ema_alpha: float = 0.3          # EMA weight on the newest observation
    t_threshold_s: float = 120.0    # min net idle saving to justify a stop
    t_buffer_s: float = 45.0        # pre-warm safety buffer
    calibration_rounds: int = 2     # round1=cold, round2=warm
    checkpoint_every_s: float = 60.0
    # wall time a preemption-notice-triggered checkpoint takes to write
    # to cloud storage; the snapshot only lands if the provider's
    # warning window (`Provider.preemption_notice_s`) is at least this
    # long, else the engine falls back to periodic-checkpoint (lost
    # work) semantics
    warning_ckpt_write_s: float = 10.0
    # model-state megabytes one warning-window checkpoint writes — what
    # the provider's `StorageRates` (S3 PUT + per-MB egress) bill; the
    # default rates are zero, so this only costs dollars once a
    # provider sets non-zero storage rates
    warning_ckpt_size_mb: float = 64.0


@dataclasses.dataclass(frozen=True)
class FLRunConfig:
    dataset: str
    clients: Tuple[ClientProfile, ...]
    n_epochs: int                   # global FL rounds (1 local epoch each)
    # on_demand | spot | fedcostaware | fedcostaware_async
    policy: str = "fedcostaware"
    algorithm: str = "fedavg"       # fedavg | fedprox | fedavgm
    fedprox_mu: float = 0.01
    server_momentum: float = 0.9
    local_steps: Optional[int] = None  # mesh-FL: steps per round
    # async (FedBuff-style) engines: aggregate once `buffer_k` client
    # results arrive; None -> n_clients - 1 (wait for all but the
    # slowest). Ignored by the synchronous engine.
    buffer_k: Optional[int] = None
    # None -> the policy's own cross_provider default; True/False
    # overrides whether cheapest-zone placement may arbitrate across
    # every provider in the market or stays on the default provider
    cross_provider: Optional[bool] = None
    # None -> the policy's own round engine ("sync" unless the policy
    # says otherwise, e.g. fedcostaware_async); "sync" |
    # "async_buffered" overrides it. Resolved before the fleet-path
    # decision, so forcing async on a fleet-capable policy falls back
    # to the per-object engines.
    engine: Optional[str] = None
    # None -> the policy's own on_warning default; "ignore" | "drain" |
    # "checkpoint" overrides how the run reacts to a provider's
    # preemption-notice warning (see `repro_torch.core.strategy`). The
    # override flows through the policy knob, so a composition whose
    # `WarningReactionSpec` pins an explicit mode keeps that mode.
    on_warning: Optional[str] = None
    # publish a `DirectiveIssued` event for every strategy directive
    # the DirectiveExecutor applies (observability; off by default so
    # recorded streams and golden traces stay unchanged)
    trace_directives: bool = False
    # cross-device cohort mode (fleet core): a large client population
    # described by distribution parameters instead of `clients`
    # profiles; each round samples `cohort_size` participants from it.
    # Setting `population` requires `clients == ()` and engages the
    # vectorized fleet path regardless of `fleet_threshold`.
    population: Optional[PopulationConfig] = None
    # participants sampled (without replacement, seeded) per round from
    # the population — None means every active client trains each round
    cohort_size: Optional[int] = None
    # fleet-path switch: None auto-selects (population set, or at least
    # `CloudConfig.fleet_threshold` clients on a sync-engine policy);
    # True forces the vectorized core even for tiny runs (equivalence
    # tests); False forces the per-object path at any scale
    fleet: Optional[bool] = None
    # communication-cost modeling (`repro_torch.comms`): the per-update
    # payload each client uploads after local training, in MB of fp32
    # state. None disables the comms subsystem entirely (no
    # ClientUpdateSent events, no transfer billing, no makespan
    # extension — byte-identical to pre-comms streams). When trainer
    # hooks expose a real param pytree (`TrainerHooks.update_payload`),
    # that measured payload wins over this modeled value.
    update_payload_mb: Optional[float] = None
    # quantize client updates through the `grad_quant` int8 codec:
    # payload bytes follow the kernel's exact (block + scale) layout
    # (~4x smaller egress), and hooks that train for real
    # (`repro_torch.fl.training.MeshTrainerHooks`) round-trip every update
    # through quantize/dequantize before aggregation
    quantize_updates: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.population is not None and self.clients:
            raise ValueError(
                "FLRunConfig: pass either explicit `clients` profiles "
                "or a `population`, not both")
        if self.cohort_size is not None:
            n = (self.population.n_clients if self.population is not None
                 else len(self.clients))
            if not 0 < self.cohort_size <= n:
                raise ValueError(
                    f"cohort_size must be in [1, {n}], "
                    f"got {self.cohort_size}")
