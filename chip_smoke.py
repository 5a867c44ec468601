#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
the sources in the checkout, holds each against its plain PyTorch
version on the card, and drives the port's main path — the port's
`FLCloudRunner` (FedCostAware policy, sync engine) with
`TorchTrainerHooks` on the card, one 1-round run of the fp32 arm then
one of the int8 arm — for each of four models at full width with the
depth cut: phi3-mini-3.8b (2 layers), mamba2-1.3b (2 layers),
recurrentgemma-2b (3 layers, one (RG-LRU, RG-LRU, local attention)
block) and granite-moe-3b-a800m (2 layers of GQA attention and a GShard
MoE of 40 experts, top 8; the MoE runs no kernel of the port's, its
4-D expert leaves go through the int8 codec). Every kernel's launch
counter is set to 0 just before each
model's runs and read just after, and each count must be what that
model's path launches. Each run's dollars (to 1e-9) and event trace
(byte for byte) must equal those of the same runner on the CPU with a
payload-only stub of the same parameter tree, and a counted round
(`launch.roofline.WorkCounter`) must carry each kernel's own work once
a launch; one round of each is then profiled (`torch.profiler`: the
device's busy share and its ten longest ops; with host activity, its
device time by the aten op and shapes that launched it). Then, for phi3
and mamba2,
the real-training Table I row
(`repro_torch.benchmarks.table1.run_real_rows`, MNIST's market):
`calibrate` anchors the simulated epochs to the measured round, both
arms run 2 calibrated rounds, and `assert_comm_win` must pass; its
launches are counted the same way. Then the same row's int8 arm at
phi3's main path under the learned forecast policy
(`repro_torch.forecast.register_learned_policy`; `phase_forecast_report`,
`[forecast]` and `[report]` lines), its event log recorded under
`build/`: its launches must be exactly those of its calibration and its
2 rounds, the port's report (`repro_torch.cloud.report`) must reconcile
the log to 1e-9 and sum it to the run's dollars, the log must hold
`ForecastUpdated` records, and its dollars (to 1e-9) and log (byte for
byte) must equal the same run's on the CPU over a payload-only stub with
the card's calibrated profiles; the report's `validate` screens the row
from its counted work at the card's measured peaks, a sweep of 8 cells
(`repro_torch.sweep`) over a pool of spawned workers must equal its
serial run within `SWEEP_LIMIT_S`, and the port's forecast_quality and
forecast_prewarm benchmarks must pass their own asserts. Then it checks a SMOKE-size run of
each of the registry's ten models on the card against the same run on
the CPU (nine through one FL round of each arm; llama-3.2-vision-90b,
whose cross-attention layers need a `cond` batch the hooks do not draw,
through one fp32 loss and gradient), and times each
kernel beside its plain version, its bound and the PyTorch library call
that computes the same function where there is one (a yardstick only;
the port never calls it), and one round of each model. After the build
it reads the
SASS of the two tensor-core libraries, bf16 flash attention and the
bf16 SSD scan, and fails unless every head dim's and every state dim's
instance runs its products on the tensor cores (HGMMA) and ptxas
reports no spill in either, nor in the RG-LRU scan's library. mamba2's
ssd launches must all go to the tensor-core kernel, and recurrentgemma's
backward must run the fused RG-LRU backward, never the reverse scan
alone.

Then FL in the mesh (`phase_mesh_fl`, `[mesh]` lines), at phi3-mini-3.8b's
main path: one `repro_torch.fl.mesh_fl.make_fl_round_step` round of two
stacked clients (2 local steps each, weights [3, 1]), whose slots must
be bit-identical after the barrier, whose losses must equal
`TorchTrainerHooks._local_train`'s from the same start on the same
batches, and which must launch flash 16 times (2 clients x 2 steps x 2
layers x 2 under remat); the int8 ring (`fedavg_sync_compressed`) over
two gloo ranks in two processes on the one card, whose models must be
bit-identical and within the int8 bound of the plain barrier, each rank
receiving (n-1)(numel + 8) bytes over the leaves; one local step
counted on the meta device (`launch/dryrun.py`'s way) and on the card,
whose FLOPs and kernel work must be equal and bytes within
`MESH_BYTES_TOL`; the FULL phi3 train_4k cell's dry-run roofline
against the card's measured peaks; and phi3 SMOKE's round on the card
against the CPU.

Then the decode path and the drivers (`repro_torch.launch`). At each of
the four main paths' full width and depth (`phase_serve`), the serving
driver prefills a prompt of 1024 tokens (recurrentgemma-2b: 2100, past
its window of 2048, so its local attention's ring buffer wraps) by
decode steps and decodes 32 greedy tokens in bf16; the decode loop must
launch no kernel of the port's, one forward over the prompt and the
prefill step each kernel once a layer of its kind, and the prefill step
must equal the forward's last row bit for bit; prefill ms and decode
ms/token are printed. The same driver in fp32 at the same shapes keeps
its teacher-forced logits, which must lie within `DECODE_BAR` of the
fp32 forward's at every prompt position (granite-moe: where the decode
and the forward chose the same experts, at most `ROUTE_FLIPS` of the
positions choosing otherwise), and recurrentgemma's decode must lie
over that bar from forwards whose window is one key short or long.
Every registry config's SMOKE decode (16 steps, fp32) is held to the
CPU's (`phase_decode_smoke`). The training driver (`phase_train`) runs
phi3-mini-3.8b's main path with two micro-batches a step: 6 steps
uninterrupted, then 3 steps to a checkpoint and a restart from it to
step 6, whose parameters and optimizer state must lie within 2 ulps of
each leaf's largest entry of the uninterrupted run's, and each run must launch flash exactly once a layer a
micro-batch in the forward and once in the backward's recompute; ms/step
and tokens/s are printed. One `make_train_step` step of
the SMOKE phi3, mamba2, recurrentgemma and granite-moe configs on the
card is held to the CPU's.

Then the paper's own CNN path (`phase_paper_path`), which runs no kernel
of the port's (cuDNN and cuBLAS; the counts must stay 0): the MNIST row
of Table I in full as `repro_torch.examples.paper_reproduction` runs it
(small_cnn, 3 clients, 10 epochs, on_demand, spot and fedcostaware, a
checkpoint every 5 batches), one FedCostAware round of resnet18
(CIFAR-10) and of resnet50 (AI-READI) at full width, and a local epoch
of efficientnet (Fed-ISIC2019). Each run's dollars (to 1e-9) and trace
(byte for byte) must equal the same runner's on the CPU over a
`ServerTrainerHooks` stub, the MNIST global models must reach accuracy
0.8, and each model's client training on the card must equal the CPU's
(`PAPER_PARITY`); each model's local epoch is timed on the host clock,
with CUDA events and under `torch.profiler`.

After the learned-forecast row, the port's benchmarks on the card's
machine (`phase_benchmarks`, `[bench]` lines), where no kernel may
launch: `repro_torch.benchmarks.fig5_costs` and `fig4_timeline` render
the row's event log, which the card recorded; fig5's last round must
hold each client's dollars and its total the run's (4 decimals and
1e-9), and each client's fig4 states must tile one timeline that ends
with the last round, before the makespan by less than one forecast
poll. `roofline_report` must carry the FULL phi3 train_4k dry-run
record that `phase_mesh_fl` made at the card's measured peaks and wrote
to the port's dry-run path (`build/dryrun_torch.json`). The section
driver's runs (`repro_torch.benchmarks.expected.RUNS`: `run` over
Table I, Fig. 4, Fig. 5 and the preemption sweep, the preemption
realism, multi-cloud, accounting and scaling benchmarks, the scaling
one writing `build/BENCH_scaling_torch.json`, and the preemption
example) run on the host, each equal to the JAX package's output
committed under `tests/torch_expected/benchmarks/` with wall seconds,
RSS and speedups masked; the scaling rows' and the accounting bench's
wall seconds are printed as host timings.

Any failure exits non-zero. Without a CUDA device, or outside a
checkout, it exits non-zero before printing any result. The last two
lines of standard output are the card's name and power limit as
`nvidia-smi` reports them, and
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Before them comes one `{"kernels": [...]}` line.
"""
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound
# of a kernel is the larger of its bytes over HBM bandwidth and its
# operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# flash at phi3-mini-3.8b's layer: B, S, N, H
MAIN_B, MAIN_S, MAIN_N, MAIN_H = 4, 1024, 32, 96
# flash at granite-moe-3b-a800m's layer (24 heads, kv expanded from 8):
# B, S, N, H; its row in the kernels line
FLASH_GRANITE = (4, 1024, 24, 64)
FLASH_GRANITE_ROW = "flash_attention_fwd@granite-moe-3b-a800m"
CLIENTS = ("client_0", "client_1")
LR = 5e-3                           # the hooks' default

# The main paths (the package's `benchmarks.table1.MAIN_PATHS`: model ->
# depth, batch, sequence), and the leaves that may stay put in each
# one's round: mamba2's D (all ones) and recurrentgemma's bf16 wo and wv
# take steps far below half an ulp of their entries in two steps
MAY_STAY = {"phi3-mini-3.8b": (),
            "mamba2-1.3b": ("blocks/00_mamba2/mix/D",),
            "recurrentgemma-2b": ("blocks/02_local_attn/mix/wo",
                                  "blocks/02_local_attn/mix/wv"),
            "granite-moe-3b-a800m": ()}
# ssd at mamba2-1.3b's layer: b, s, heads, head dim, groups, state, chunk
SSD_MAIN = (2, 2048, 64, 64, 1, 128, 256)
RGLRU_MAIN = (1, 4096, 2560)        # recurrentgemma-2b's layer: B, S, W
# flash at recurrentgemma-2b's local attention: B, S, N, H, window; its
# row in the kernels line
FLASH_RG = (1, 4096, 10, 256, 2048)
FLASH_RG_ROW = "flash_attention_fwd@recurrentgemma-2b"
FLASH_SM90 = ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_fwd_sm90.cu")
SSD_SM90 = "src/repro_torch/kernels/ssd/csrc/ssd_fwd_sm90.cu"
RGLRU_SRC = "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu"
# the real-training Table I row: its dataset (whose market and epoch
# times the calibrated runs take), FL rounds a run, and the main paths
# it runs at (recurrentgemma's is left out for the script's time: its
# two arms' hooks alone draw 1.65 billion parameters on the host)
REAL_ROW, REAL_ROUNDS = "MNIST", 2
REAL_PATHS = ("phi3-mini-3.8b", "mamba2-1.3b")


def paths():
    """(model, depth, batch, sequence, leaves that may stay put) of each
    main path, in the order the script runs them."""
    from repro_torch.benchmarks.table1 import MAIN_PATHS
    return [(arch, *MAIN_PATHS[arch], MAY_STAY[arch]) for arch in MAY_STAY]


def _check_shapes():
    """Each kernel's checked and timed shape is its main path's."""
    from repro_torch.benchmarks.table1 import MAIN_PATHS
    from repro_torch.configs import get_config
    main = {arch: v[1:] for arch, v in MAIN_PATHS.items()}
    phi3 = get_config("phi3-mini-3.8b")
    granite = get_config("granite-moe-3b-a800m")
    _check((MAIN_B, MAIN_S) == main["phi3-mini-3.8b"]
           and (MAIN_N, MAIN_H) == (phi3.num_heads, phi3.resolved_head_dim)
           and FLASH_GRANITE == (*main["granite-moe-3b-a800m"],
                                 granite.num_heads, granite.resolved_head_dim)
           and SSD_MAIN[:2] == main["mamba2-1.3b"]
           and RGLRU_MAIN[:2] == FLASH_RG[:2] == main["recurrentgemma-2b"],
           f"a kernel shape is not its main path's: {MAIN_PATHS}")


def _fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        _fail(msg)


def _time_ms(fn, iters=10, warmup=2):
    """Mean device milliseconds of `fn` over `iters` runs, CUDA events.
    The runs are queued behind a sleep kernel of about 50 ms, so the card
    runs them back to back and the host's time to issue a short kernel
    stays out of its time (a run the host takes longer than that to issue,
    such as a plain version's loop, still counts the host's time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(flops, nbytes, dtype):
    """The least time the card takes for `flops` of `dtype` and `nbytes`
    (each kernel's counts from `launch.roofline`, which the port's
    `WorkCounter` also adds up)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _counters():
    """Every kernel wrapper that counts its launches, by name."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_quant import ops as gq
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.ssd import ops as sd
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "quantize": gq.quantize, "dequantize": gq.dequantize,
            "ssd_fwd": sd.ssd_fwd, "rglru_scan_fwd": rg.rglru_scan_fwd,
            "rglru_scan_reverse": rg.rglru_scan_reverse,
            "rglru_scan_bwd": rg.rglru_scan_bwd}


def _kernel_name(mangled):
    """A kernel's name and integer (and int or long long) template
    arguments from its mangled name: `flash_fwd_sm90_kernel<96,128>`,
    `rglru_scan_kernel<2,12,int>`."""
    pos = 3 if mangled.startswith("_ZN") else 2
    while True:
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            return mangled
        size = int(m.group())
        pos += len(m.group())
        ident, pos = mangled[pos:pos + size], pos + size
        if ident.endswith("kernel"):
            args = re.match(r"I((?:Li-?\d+E)+)([ix]?)E", mangled[pos:])
            if args is None:
                return ident
            ints = re.findall(r"Li(-?\d+)E", args.group(1))
            if args.group(2):
                ints.append({"i": "int", "x": "long long"}[args.group(2)])
            return f"{ident}<{','.join(ints)}>"


def _ptxas_lines(log):
    """ptxas's register and spill lines, each under its kernel's name."""
    name = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "registers" in line or "spill" in line:
            yield f"{name}: {line.strip()}"


def _hgmma_counts(stem):
    """HGMMA (wgmma) instructions in the SASS of each kernel instance of
    the library built from `stem`, printed and returned by name."""
    from repro_torch.kernels import _build
    sass = subprocess.run(
        [_build.cuda_tool("cuobjdump"), "-sass",
         str(_build.library_path(stem))],
        capture_output=True, text=True, check=True).stdout
    counts = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        counts[_kernel_name(block.split()[0])] = block.count("HGMMA")
    for name, c in counts.items():
        print(f"[build] {stem} SASS: {name}: {c} HGMMA")
    return counts


def _check_hgmma():
    """Every head dim's instance of the bf16 flash library, and every
    instance of the bf16 ssd library (each state dim, p up to 64 and up
    to 128), has wgmma (HGMMA) instructions in its SASS, and ptxas
    reports no spill in either library, nor in the rglru library."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.ssd import ops as sd
    for stem, dims_want, what in [(fa._STEM_SM90, fa.HEAD_DIMS, "head"),
                                  (sd._STEM_SM90, sd.STATE_DIMS, "state")]:
        counts = _hgmma_counts(stem)
        dims = {int(m.group(1)) for name, c in counts.items() if c > 0
                for m in [re.search(r"<(\d+)", name)] if m}
        _check(dims == set(dims_want) and all(counts.values()),
               f"HGMMA in the {stem} instances of {what} dims "
               f"{sorted(dims)}, want {list(dims_want)}, each instance: "
               f"{counts}")
    for stem in (fa._STEM_SM90, sd._STEM_SM90, rg._STEM):
        spills = [line for line in _ptxas_lines(_build.build_log(stem))
                  if re.search(r"\b[1-9]\d* bytes spill", line)]
        _check(not spills, f"{stem} spills: {spills}")


def phase_build():
    from repro_torch.kernels import _build
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    secs = _build.build_all()
    print(f"[build] {len(_build.sources())} kernel sources built in "
          f"{secs:.2f} s")
    for stem in _build.sources():
        for line in _ptxas_lines(_build.build_log(stem)):
            print(f"[build] {stem}: {line}")
    _check_hgmma()


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda")
            * scale).to(dtype)


def _ssd_inputs(gen, b, s, h, p, g, n, dtype=torch.float32):
    return (_randn(gen, b, s, h, p, dtype=dtype, scale=0.5),
            -_randn(gen, b, s, h).abs() * 0.1,
            _randn(gen, b, s, g, n, dtype=dtype, scale=0.3),
            _randn(gen, b, s, g, n, dtype=dtype, scale=0.3))


def _rglru_inputs(gen, B, S, W):
    # recurrentgemma's decays: log a = -8 r softplus(lam), to about -55
    return (-torch.rand(B, S, W, generator=gen, device="cuda") * 8.0,
            _randn(gen, B, S, W, scale=0.5))


def _check_flash_bf16(fa, gen, B, S, N, H, window):
    """The bf16 kernel against the plain version in fp32 on the same
    bf16 inputs: the kernel computes in fp32 and rounds its output to
    bf16 once, so each output lies within half a bf16 ulp (at most 2^-8
    of itself) of the fp32 result, plus fp32 rounding. Returns max |err|."""
    q, k, v = (_randn(gen, B, S, N, H, dtype=torch.bfloat16)
               for _ in range(3))
    out = fa.flash_attention_fwd(q, k, v, window=window)
    torch.cuda.synchronize()
    _check(out.dtype == torch.bfloat16, f"flash bf16 gave {out.dtype}")
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    window=window)
    err = (out.float() - want).abs()
    top = want.abs().max().item()
    bar = 2.0 ** -8 * want.abs() + 1e-5 * top
    worst = (err / bar).max().item()
    _check(bool((err <= bar).all()),
           f"flash bf16 {(B, S, N, H)} window={window}: max |err| "
           f"{err.max().item()}, {worst} of the bar, against the fp32 "
           f"plain version")
    print(f"[kernels] flash bf16 {(B, S, N, H)} window={window}: max |err| "
          f"{err.max().item():.3e} against the fp32 plain version, "
          f"{err.max().item() / top:.3e} of max |ref|, worst element "
          f"{worst:.3f} of its bar (2^-8 |ref| + 1e-5 max |ref|, one bf16 "
          f"rounding)")
    return err.max().item()


def phase_kernels(gen):
    """Each kernel against its plain version on the card."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_quant import ops as gq

    errs = {"flash_attention_fwd": _check_flash_bf16(
        fa, gen, MAIN_B, MAIN_S, MAIN_N, MAIN_H, None)}
    B, S, N, H, window = FLASH_RG
    errs[FLASH_RG_ROW] = _check_flash_bf16(fa, gen, B, S, N, H, window)
    errs[FLASH_GRANITE_ROW] = _check_flash_bf16(fa, gen, *FLASH_GRANITE,
                                                None)

    # fp32: every head dim, 8 included (the SMOKE configs with d_model 64
    # over 8 heads), ragged lengths, windows and softcaps
    for (B, S, N, H, window, softcap) in [
            (2, 256, 2, 64, None, None), (1, 512, 2, 32, 128, None),
            (2, 200, 2, 96, None, 30.0), (1, 300, 1, 256, None, None),
            (1, 600, 2, 256, 128, None), (2, 77, 4, 16, None, None),
            (1, 130, 2, 128, 64, 10.0), (2, 64, 8, 8, None, None),
            (2, 77, 8, 8, None, None), (1, 300, 8, 8, 64, 10.0)]:
        q, k, v = (_randn(gen, B, S, N, H) for _ in range(3))
        out = fa.flash_attention_fwd(q, k, v, window=window, softcap=softcap)
        want = fa.flash_attention_plain(q, k, v, window=window,
                                        softcap=softcap)
        err = (out - want).abs()
        _check(bool((err <= 2e-5 + 2e-5 * want.abs()).all()),
               f"flash fp32 {(B, S, N, H, window, softcap)}: max |err| "
               f"{err.max().item()}")
        print(f"[kernels] flash fp32 {(B, S, N, H)} window={window} "
              f"softcap={softcap}: max |err| {err.max().item():.3e} "
              f"(tolerance 2e-5)")

    tie = torch.zeros(gq.BLOCK, device="cuda")
    tie[:7] = torch.tensor([127.0, 2.5, 3.5, -2.5, -3.5, 0.5, -0.5])
    for name, x in [("(2, 3072, 8192) leaf",
                     _randn(gen, 2, 3072, 8192, scale=1e-3)),
                    ("ragged 6149", _randn(gen, 2 * 3072 + 5, scale=1e-3)),
                    ("half-way ties", tie)]:
        _check_codec(gq, x, name)
    q, _ = gq.quantize(tie)
    _check(q[0, :7].tolist() == [127, 2, 4, -2, -4, 0, 0],
           f"codec ties rounded {q[0, :7].tolist()}")

    _check_ssd(gen, errs)
    _check_rglru(gen, errs)
    return errs


def _check_codec(gq, x, name):
    q, s = gq.quantize(x)
    qp, sp = gq.quantize_plain(x)
    _check(torch.equal(q, qp) and torch.equal(s, sp),
           f"quantize {name}: kernel and plain version differ")
    back = gq.dequantize(q, s, x.shape)
    _check(torch.equal(back, gq.dequantize_plain(q, s, x.shape)),
           f"dequantize {name}: kernel and plain version differ")
    print(f"[kernels] codec {name}: int8 values, scales and dequantized "
          f"values bit-equal")


def _check_ssd_bf16(sd, gen, shape, la_scale, sm90=True):
    """The bf16 ssd kernel at `shape` with log decays -|z| la_scale: 2e-2
    of the largest output against the plain version in bf16, and one
    bf16 rounding (2^-8 |ref| + 1e-5 max |ref|) against the plain version
    in fp32 on the same bf16 inputs, which the tensor-core kernel meets
    by carrying its three fp32 operands as bf16 hi + lo and the CUDA-core
    one (`sm90` false) by computing in fp32. Returns max |err| against
    the fp32 plain version."""
    b, s, h, p, g, n, chunk = shape
    x, la, B, C = _ssd_inputs(gen, b, s, h, p, g, n, torch.bfloat16)
    la = la * (la_scale / 0.1)
    before = sd.ssd_fwd.sm90_launches
    y = sd.ssd_fwd(x, la, B, C, chunk=chunk)
    torch.cuda.synchronize()
    kernel = "tensor-core" if sm90 else "CUDA-core"
    _check(sd.ssd_fwd.sm90_launches == before + int(sm90),
           f"ssd bf16 {shape} did not run on the {kernel} kernel")
    rel = _rel_err(y, sd.ssd_plain(x, la, B, C, chunk=chunk)[0])
    _check(y.dtype == torch.bfloat16 and rel <= 2e-2,
           f"ssd bf16 {shape}: {y.dtype}, relative error {rel}")
    want, _ = sd.ssd_plain(x.float(), la, B.float(), C.float(), chunk=chunk)
    err = (y.float() - want).abs()
    top = want.abs().max().item()
    bar = 2.0 ** -8 * want.abs() + 1e-5 * top
    worst = (err / bar).max().item()
    _check(bool((err <= bar).all()),
           f"ssd bf16 {shape} decay scale {la_scale}: max |err| "
           f"{err.max().item()}, {worst} of the bar, against the fp32 plain "
           f"version")
    print(f"[kernels] ssd bf16 (b, s, h, p, g, n, chunk)={shape} on the "
          f"{kernel} kernel, log decay "
          f"-|z|*{la_scale}: {rel:.3e} of max |ref| against the bf16 plain "
          f"version (tolerance 2e-2); max |err| {err.max().item():.3e} "
          f"against the fp32 plain version, {err.max().item() / top:.3e} of "
          f"max |ref|, worst element {worst:.3f} of its bar (2^-8 |ref| + "
          f"1e-5 max |ref|, one bf16 rounding)")
    return err.max().item()


def _check_ssd(gen, errs):
    from repro_torch.kernels.ssd import ops as sd
    errs["ssd_fwd"] = _check_ssd_bf16(sd, gen, SSD_MAIN, 0.1)
    # mamba2-like decays (cs falls by about a hundred over a 128-row
    # piece), at the main shape and at a ragged S
    _check_ssd_bf16(sd, gen, SSD_MAIN, 1.0)
    _check_ssd_bf16(sd, gen, (2, 1000, 64, 64, 1, 128, 256), 1.0)
    # bf16 head dims off the tensor maps (no multiple of 8, or over 128)
    # stay on the CUDA-core kernel: its bf16 instance at every state dim
    for case in [(2, 300, 4, 20, 1, 128, 64), (1, 100, 4, 136, 2, 64, 8),
                 (1, 200, 2, 12, 1, 32, 256), (2, 64, 3, 20, 3, 16, 16)]:
        _check_ssd_bf16(sd, gen, case, 1.0, sm90=False)
    # ragged S, chunks of 8, 64 and 256, one and two groups, every state
    # dim, a head dim that is no multiple of the block's 32 columns
    for case in [(2, 64, 3, 16, 3, 16, 16), (1, 100, 4, 32, 2, 64, 8),
                 (2, 300, 4, 64, 1, 128, 64), (1, 520, 2, 24, 1, 32, 256),
                 (1, 256, 8, 64, 2, 128, 256)]:
        b, s, h, p, g, n, chunk = case
        x, la, B, C = _ssd_inputs(gen, b, s, h, p, g, n)
        before = sd.ssd_fwd.sm90_launches
        rel = _rel_err(sd.ssd_fwd(x, la, B, C, chunk=chunk),
                       sd.ssd_plain(x, la, B, C, chunk=chunk)[0])
        _check(sd.ssd_fwd.sm90_launches == before,
               f"ssd fp32 {case} ran on the tensor-core kernel")
        _check(rel <= 1e-5, f"ssd fp32 {case}: relative error {rel}")
        print(f"[kernels] ssd fp32 (b, s, h, p, g, n, chunk)={case} on the "
              f"CUDA-core kernel: {rel:.3e} of max |ref| (tolerance 1e-5)")


def _check_rglru(gen, errs):
    """Forward and reverse against their plain versions, and the fused
    backward against the autograd gradient of the plain forward, each at
    1e-5 of the largest reference entry; at recurrentgemma's layer and at
    ragged shapes (S of 1, under one segment, over several rounds of a
    cluster)."""
    from repro_torch.kernels.rglru import ops as rg
    for shape in (RGLRU_MAIN, (2, 100, 24), (3, 37, 130), (2, 1, 40),
                  (1, 5000, 40)):
        la, u = _rglru_inputs(gen, *shape)
        gh = _randn(gen, *shape)
        h_ref = rg.rglru_scan_ref(la, u)
        h, g = rg.rglru_scan_fwd(la, u), rg.rglru_scan_reverse(la, u)
        dla, db = rg.rglru_scan_bwd(la, h_ref, gh)
        torch.cuda.synchronize()
        g_ref = rg.rglru_scan_reverse_ref(la, u)
        la_, u_ = (x.clone().requires_grad_() for x in (la, u))
        dla_ref, db_ref = torch.autograd.grad(rg.rglru_scan_ref(la_, u_),
                                              (la_, u_), gh)
        rels = {name: (got - want).abs().max().item()
                / max(want.abs().max().item(), 1e-30)
                for name, got, want in [("forward", h, h_ref),
                                        ("reverse", g, g_ref),
                                        ("dlog_a", dla, dla_ref),
                                        ("db", db, db_ref)]}
        _check(max(rels.values()) <= 1e-5,
               f"rglru {shape}: relative errors {rels}")
        if shape == RGLRU_MAIN:
            errs["rglru_scan_fwd"] = (h - h_ref).abs().max().item()
            errs["rglru_scan_reverse"] = (g - g_ref).abs().max().item()
            errs["rglru_scan_bwd"] = max((dla - dla_ref).abs().max().item(),
                                         (db - db_ref).abs().max().item())
        print(f"[kernels] rglru fp32 {shape}: forward {rels['forward']:.3e}, "
              f"reverse {rels['reverse']:.3e} of max |ref|; fused backward "
              f"dlog_a {rels['dlog_a']:.3e}, db {rels['db']:.3e} of max "
              f"|autograd of the plain forward| (tolerance 1e-5)")
    la, u = _rglru_inputs(gen, 2, 200, 40)
    la.requires_grad_()
    u.requires_grad_()
    gh = _randn(gen, 2, 200, 40)
    got = torch.autograd.grad(rg.rglru_scan(la, u), (la, u), gh)
    want = torch.autograd.grad(rg.rglru_scan_ref(la, u), (la, u), gh)
    rels = [_rel_err(a, b) for a, b in zip(got, want)]
    _check(max(rels) <= 1e-5, f"rglru backward: relative errors {rels}")
    print(f"[kernels] rglru backward (2, 200, 40): dlog_a {rels[0]:.3e}, db "
          f"{rels[1]:.3e} of max |autograd of the plain forward| "
          f"(tolerance 1e-5)")


def _fl_run(hooks, quantize):
    """One 1-round run of the port's runner (FedCostAware, sync engine)
    over `hooks`, uncalibrated, on the real-training row's market, which
    prices egress, so the run bills a nonzero comm_cost. Returns the
    RunResult and the recorded event trace."""
    from repro_torch.benchmarks.table1 import ROWS, comm_market
    from repro_torch.common.config import (CloudConfig, ClientProfile,
                                           FLRunConfig)
    from repro_torch.fl.runner import FLCloudRunner

    row = next(r for r in ROWS if r.dataset == REAL_ROW)
    clients = tuple(ClientProfile(c, mean_epoch_s=row.epoch_s[i],
                                  cold_multiplier=1.12, jitter=0.0)
                    for i, c in enumerate(CLIENTS))
    cfg = FLRunConfig(dataset=row.dataset, clients=clients, n_epochs=1,
                      policy="fedcostaware", seed=0,
                      quantize_updates=quantize)
    cloud = CloudConfig(spin_up_mean_s=row.spin_up_s, spin_up_sigma=0.0,
                        market=comm_market(row))
    runner = FLCloudRunner(cfg, cloud_cfg=cloud, hooks=hooks, record=True)
    return runner.run(), runner.recorder.dumps()


def _payload_stub(cfg):
    """Hooks that train nothing and bill the payload of `cfg`'s parameter
    tree, held as shapes only (meta tensors)."""
    from repro_torch.common.bridge import unflatten
    from repro_torch.comms.payload import UpdatePayload
    from repro_torch.fl.types import TrainerHooks
    from repro_torch.models import lm

    tree = unflatten({k: torch.empty(shape, dtype=dtype, device="meta")
                      for k, (shape, dtype) in lm.param_shapes(cfg)})

    class PayloadStub(TrainerHooks):
        def aggregate(self, participants, round_idx, staleness=None):
            pass

        def update_payload(self, quantized=False):
            return UpdatePayload.from_tree(tree, quantized=quantized)

    return PayloadStub()


def _reset_counters():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    counters["ssd_fwd"].sm90_launches = 0
    return counters


def _expected_launches(cfg, n_leaves, train_rounds=2,
                       codec_updates=len(CLIENTS)):
    """What `train_rounds` rounds of local training of every slot and
    the int8 arm's codec over `codec_updates` participant deltas of `cfg`
    launch (by default the main path: one fp32 round, then one int8
    round): a layer's forward kernels once a step, twice in the stacked
    blocks under remat (the forward and the recompute), the RG-LRU fused
    backward once a step in the backward (the reverse scan alone never),
    and the codec on every leaf of every delta."""
    from repro_torch.benchmarks.table1 import LOCAL_STEPS
    steps = train_rounds * len(CLIENTS) * LOCAL_STEPS

    def layers(*kinds, fwd=True):
        per_block = sum(cfg.pattern.count(k) for k in kinds) * cfg.n_super
        tail = sum(cfg.tail_pattern.count(k) for k in kinds)
        return steps * (per_block * (2 if fwd and cfg.remat else 1) + tail)

    return {"flash_attention_fwd": layers("attn", "local_attn"),
            "quantize": codec_updates * n_leaves,
            "dequantize": codec_updates * n_leaves,
            "ssd_fwd": layers("mamba2"),
            "rglru_scan_fwd": layers("rglru"),
            "rglru_scan_reverse": 0,
            "rglru_scan_bwd": layers("rglru", fwd=False)}


def phase_main_path(arch, layers, batch, seq, may_stay):
    """One model's main path at full width, depth cut to `layers`."""
    from repro_torch import configs
    from repro_torch.benchmarks.table1 import LOCAL_STEPS
    from repro_torch.common.bridge import flatten_with_paths
    from repro_torch.comms.payload import quantized_leaf_bytes
    from repro_torch.fl.training import TorchTrainerHooks

    cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers)

    def make(quantize):
        return TorchTrainerHooks(CLIENTS, cfg=cfg, local_steps=LOCAL_STEPS,
                                 batch=batch, seq=seq, lr=LR,
                                 quantize=quantize, seed=0, device="cuda")

    gc.collect()        # an earlier path's hooks, held by its runner
    torch.cuda.reset_peak_memory_stats()
    hooks = make(False)
    init = {k: v.clone() for k, v in flatten_with_paths(hooks.params)}
    n_params = sum(v.numel() for v in init.values())
    print(f"[main] {cfg.name} d_model={cfg.d_model} pattern={cfg.pattern} "
          f"layers={cfg.num_layers} vocab={cfg.vocab_size} {cfg.param_dtype} "
          f"remat={cfg.remat}: {n_params} parameters in {len(init)} leaves; "
          f"{len(CLIENTS)} clients, local_steps={LOCAL_STEPS}, "
          f"batch={batch}, seq={seq}")

    counters = _reset_counters()
    runs = {"fp32": _fl_run(hooks, quantize=False)}
    fp32_losses = [r["mean_loss"] for r in hooks.losses]
    fp32_payload = hooks.update_payload(quantized=False)
    # the runner's event bus and engines hold one another, so the fp32
    # arm's hooks stay alive until the cycle collector frees them
    del hooks
    gc.collect()
    hooks = make(True)
    runs["int8"] = _fl_run(hooks, quantize=True)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    ssd_sm90 = counters["ssd_fwd"].sm90_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    int8_losses = [r["mean_loss"] for r in hooks.losses]
    print(f"[main] {cfg.name}: fp32 arm mean losses {fp32_losses}; int8 arm "
          f"mean losses {int8_losses}; peak device memory {peak_gb:.2f} GB")
    print(f"[main] {cfg.name}: launches during its main path: {launches}; "
          f"ssd on the tensor-core kernel: {ssd_sm90}")

    _check(all(math.isfinite(x) for x in fp32_losses + int8_losses),
           f"{cfg.name}: non-finite loss")
    want = _expected_launches(cfg, len(init))
    _check(launches == want, f"{cfg.name}: launched {launches}, want {want}")
    _check(ssd_sm90 == launches["ssd_fwd"],
           f"{cfg.name}: {ssd_sm90} of its {launches['ssd_fwd']} ssd "
           f"launches on the tensor-core kernel")

    # every leaf got a gradient, and every leaf moved but those in
    # `may_stay`; one of those may stay put only if its last step,
    # LR |momentum|, is under half an ulp of its largest entry: a step
    # under half an entry's ulp rounds away, and no entry's ulp is
    # larger than the largest entry's
    final = dict(flatten_with_paths(hooks.params))
    for k in init:
        m = max(mu[k].abs().max().item() for mu in hooks.mu)
        _check(0 < m < math.inf, f"{cfg.name}: {k} got no gradient ({m})")
        if torch.equal(final[k], init[k]):
            ulp = torch.finfo(init[k].dtype).eps * init[k].abs().max().item()
            _check(k in may_stay and LR * m < ulp / 2,
                   f"{cfg.name}: {k} did not move; its step {LR * m:.3e}, "
                   f"its ulp {ulp:.3e}")
            print(f"[main] {cfg.name}: {k} did not move: step {LR * m:.3e} "
                  f"under half its ulp {ulp:.3e}")
    q_payload = hooks.update_payload(quantized=True)
    want_bytes = sum(quantized_leaf_bytes(v.numel()) for v in init.values())
    _check(q_payload.num_bytes == want_bytes,
           f"{cfg.name}: int8 payload {q_payload.num_bytes} B, leaf sum "
           f"{want_bytes} B")
    _check(q_payload.num_bytes < fp32_payload.num_bytes,
           f"{cfg.name}: int8 payload not below fp32")
    print(f"[main] {cfg.name}: payload per client update: fp32 "
          f"{fp32_payload.num_bytes} B, int8 {q_payload.num_bytes} B over "
          f"{q_payload.n_leaves} leaves")
    _check_dollars(cfg, runs)
    _check_counted_round(cfg, hooks, len(init))
    round_s = hooks.measure_round_s(warmup=1, iters=2)
    print(f"[times] {cfg.name} measure_round_s (int8 arm, {len(CLIENTS)} "
          f"clients x {LOCAL_STEPS} steps, batch {batch}, seq {seq}): "
          f"{round_s:.4f} s")
    _profile_round(cfg, hooks)
    deltas = {k: final[k].float() - init[k].float() for k in init}
    # the codec on the path's largest leaf of the highest rank (granite:
    # a 4-D expert leaf of 62.9M elements)
    from repro_torch.kernels.grad_quant import ops as gq
    big = max(deltas, key=lambda k: (deltas[k].ndim, deltas[k].numel()))
    _check_codec(gq, deltas[big], f"{cfg.name} {big} delta "
                 f"{tuple(deltas[big].shape)}")
    return launches, deltas


def _gpu_name():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _device_ops(prof):
    """(name, device seconds) of each op the device ran under `prof`."""
    return [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e6)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _profile_round(cfg, hooks):
    """One round of local training of every slot (as `measure_round_s`
    times it) under `torch.profiler`: the host window, the device's busy
    share of it, and the ten ops that kept the device busy longest; then
    one more round with host activity, whose device time is split by the
    aten op (and its input shapes) that launched each kernel."""
    from torch.profiler import ProfilerActivity, profile
    batches = hooks._next_batches()
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            hooks._local_train(hooks.params, hooks.mu[i], b)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ops = _device_ops(prof)
    busy = sum(t for _, t in ops)
    _check(busy > 0, f"{cfg.name}: the profiler saw no device time")
    top = sorted(ops, key=lambda kv: -kv[1])[:10]
    print(f"[profile] {cfg.name} one round ({len(batches)} clients x "
          f"{hooks.local_steps} steps) under torch.profiler: {window:.4f} s "
          f"on the host clock, device busy {busy:.4f} s "
          f"({100 * busy / window:.1f}%) in {len(ops)} kinds of op; "
          f"profiling took {time.perf_counter() - t_start:.1f} s; {_gpu_name()}")
    for k, t in top:
        print(f"[profile] {cfg.name}   {t:.4f} s ({100 * t / busy:.1f}% of "
              f"busy) {k[:90]}")
    # one more round with host activity and shapes: the device time of
    # the kernels each aten op launched itself, by op and input shapes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for i, b in enumerate(batches):
            hooks._local_train(hooks.params, hooks.mu[i], b)
        torch.cuda.synchronize()
    by_op = sorted(((getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) / 1e6,
                     e.key, e.input_shapes)
                    for e in prof.key_averages(group_by_input_shape=True)
                    if e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda r: -r[0])[:10]
    for t, k, shapes in by_op:
        print(f"[profile] {cfg.name}   by op: {t:.4f} s ({100 * t / busy:.1f}%"
              f" of busy) {k} {shapes}")


def _check_dollars(cfg, runs):
    """Each arm's dollars and event trace against the port's runner on
    the CPU with a payload-only stub of the same parameter tree: the
    dollars depend only on the profiles and the payload bytes."""
    stub = _payload_stub(cfg)
    for arm, (res, trace) in runs.items():
        want, want_trace = _fl_run(stub, quantize=arm == "int8")
        _check(res.comm_cost > 0, f"{cfg.name} {arm}: no egress billed")
        _check(abs(res.total_cost - want.total_cost) <= 1e-9
               and abs(res.comm_cost - want.comm_cost) <= 1e-9,
               f"{cfg.name} {arm}: card run ${res.total_cost!r} "
               f"(egress ${res.comm_cost!r}), CPU stub ${want.total_cost!r} "
               f"(egress ${want.comm_cost!r})")
        _check(trace == want_trace, f"{cfg.name} {arm}: the card run's event "
               f"trace differs from the CPU stub's")
        _check([sorted(r) for r in res.per_round_participants]
               == [sorted(CLIENTS)],
               f"{cfg.name} {arm}: participants {res.per_round_participants}")
        print(f"[dollars] {cfg.name} {arm} arm, 1 round: total "
              f"${res.total_cost!r}, egress ${res.comm_cost!r}, makespan "
              f"{res.makespan_s!r} s; equal to the CPU runner's with a "
              f"payload-only stub (to 1e-9), event trace of "
              f"{len(trace.encode())} bytes equal byte for byte")


def _check_counted_round(cfg, hooks, n_leaves):
    """One round of local training of every slot under a `WorkCounter`:
    each kernel's own work must be there once a launch."""
    wc = hooks.count_round_work()
    torch.cuda.synchronize()
    want = {k: v for k, v in _expected_launches(cfg, n_leaves, 1, 0).items()
            if v}
    got = {k: int(v[0]) for k, v in wc.kernels.items()}
    _check(got == want, f"{cfg.name}: the counted round holds kernel work "
           f"of {got} launches, want {want}")
    top = sorted(wc.bytes_by_op.items(), key=lambda kv: -kv[1])[:8]
    print(f"[count] {cfg.name} one round of local training: "
          f"{wc.flops!r} FLOPs ({wc.kernel_flops!r} in the port's kernels), "
          f"{wc.bytes_accessed!r} bytes ({wc.kernel_bytes!r} in the "
          f"kernels); kernels [launches, FLOPs, bytes]: {wc.kernels}; the "
          f"aten ops that move the most bytes: {top}")


def phase_real(arch):
    """The real-training Table I row at one main path's size, as the
    package runs it (`run_real_rows` at `MAIN_PATHS`): each arm is
    calibrated (its measured round anchors the simulated epochs) and
    runs `REAL_ROUNDS` calibrated rounds; the int8 arm must bill less
    egress at a bounded final-loss delta (`assert_comm_win`)."""
    from repro_torch.benchmarks import table1 as T1
    from repro_torch.launch.roofline import estimate_step_time
    from repro_torch.models import lm

    cfg = T1.main_path(arch)[0]
    row = next(r for r in T1.ROWS if r.dataset == REAL_ROW)
    # the main paths' hooks, held by their runners, go first, so the
    # peak read below is the real row's alone
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    counters = _reset_counters()
    recs = T1.run_real_rows(row, rounds=REAL_ROUNDS, n_clients=len(CLIENTS),
                            quantize=False, both=True, model=arch,
                            device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"[real] {cfg.name}: peak device memory over both arms "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # a calibration trains CAL_WARMUP + CAL_ITERS rounds in
    # measure_round_s and 1 in count_round_work, then the run
    # REAL_ROUNDS, each arm
    cal_rounds = T1.CAL_WARMUP + T1.CAL_ITERS + 1
    want = _expected_launches(
        cfg, len(lm.param_shapes(cfg)),
        train_rounds=2 * (cal_rounds + REAL_ROUNDS),
        codec_updates=REAL_ROUNDS * len(CLIENTS))
    print(f"[real] {cfg.name}: launches during the real-training row: "
          f"{launches}")
    _check(launches == want, f"{cfg.name} real row: launched {launches}, "
           f"want {want}")
    for r in recs:
        cal = r["calibration"]
        est_max = estimate_step_time(cal.flops, cal.bytes_accessed,
                                     peak_flops=cal.peak_flops,
                                     hbm_bw=cal.mem_bw, combine="max")
        print(f"[real] {cfg.name} {r['algorithm']}: measured round "
              f"{cal.measured_round_s!r} s (median of {T1.CAL_ITERS} after "
              f"{T1.CAL_WARMUP} warm-up); counted {cal.flops!r} FLOPs, "
              f"{cal.bytes_accessed!r} bytes; measured peaks "
              f"{cal.peak_flops!r} FLOP/s (bf16 products), {cal.mem_bw!r} "
              f"B/s (copy)")
        print(f"[real] {cfg.name} {r['algorithm']}: roofline \"sum\" "
              f"{cal.roofline_round_s!r} s, ratio {cal.ratio!r}; roofline "
              f"\"max\" {est_max!r} s, ratio "
              f"{cal.measured_round_s / est_max!r}")
        print(f"[real] {cfg.name} {r['algorithm']}: calibrated epoch "
              f"{cal.mean_epoch_s(T1._TIME_SCALE)!r} s (x{T1._TIME_SCALE:g}); "
              f"{REAL_ROUNDS} rounds cost ${r['total_cost']} (egress "
              f"${r['comm_cost']}), makespan {r['makespan_h']} h, final "
              f"loss {r['final_loss']}")
        _check(all(math.isfinite(v) and v > 0 for v in (
            cal.measured_round_s, cal.roofline_round_s, cal.flops,
            cal.bytes_accessed, cal.peak_flops, cal.mem_bw,
            r["total_cost"], r["comm_cost"])) and math.isfinite(
                r["final_loss"]), f"{cfg.name} {r['algorithm']}: {r}")
    try:
        T1.assert_comm_win(recs[0], recs[1])
    except SystemExit as e:
        _fail(f"{cfg.name} real row: {e}")


# The learned-forecast row's sweep: a grid of 2 policies x 2 markets x 2
# seeds, fanned over FORECAST_POOL spawned workers, which must finish in
# SWEEP_LIMIT_S seconds
SWEEP_GRID = dict(policies=("spot", "fedcostaware"),
                  markets=("baseline", "capacity_crunch"), seeds=range(2))
FORECAST_POOL, SWEEP_LIMIT_S = 4, 180


def _learned_stub_run(cfg, cal, row):
    """The learned-forecast row's run on the CPU, as `run_real` builds
    it, with the card's calibrated client profiles and a payload-only
    stub of `cfg`'s parameter tree: its RunResult and event log."""
    from repro_torch.benchmarks import table1 as T1
    from repro_torch.common.config import (CloudConfig, ClientProfile,
                                           FLRunConfig)
    from repro_torch.fl import training as T
    from repro_torch.fl.runner import FLCloudRunner

    profiles = tuple(
        ClientProfile(name, mean_epoch_s=row.epoch_s[i % len(row.epoch_s)],
                      cold_multiplier=1.12, jitter=0.0)
        for i, name in enumerate(CLIENTS))
    profiles = tuple(T.calibrated_profiles(profiles, cal,
                                           time_scale=T1._TIME_SCALE))
    run_cfg = FLRunConfig(dataset=row.dataset, clients=profiles,
                          n_epochs=REAL_ROUNDS, policy="learned_forecast",
                          seed=0, quantize_updates=True)
    cloud = CloudConfig(spin_up_mean_s=row.spin_up_s, spin_up_sigma=0.0,
                        market=T1.comm_market(row))
    runner = FLCloudRunner(run_cfg, cloud_cfg=cloud,
                           hooks=_payload_stub(cfg), record=True)
    return runner.run(), runner.recorder.dumps()


def _forecast_validate(cal, row, res):
    """The report's pre-launch screen of the row from its counted work:
    one round's FLOPs and bytes at the card's measured peaks, scaled as
    the row's epochs are, against a budget of what the row billed."""
    from repro_torch.benchmarks import table1 as T1
    from repro_torch.cloud import report

    argv = ["validate", "--budget", repr(res.total_cost),
            "--epochs", str(REAL_ROUNDS), "--clients", str(len(CLIENTS)),
            "--roofline-flops", repr(cal.flops),
            "--roofline-bytes", repr(cal.bytes_accessed),
            "--peak-flops", repr(cal.peak_flops), "--hbm-bw", repr(cal.mem_bw),
            "--steps-per-epoch", "1", "--time-scale", repr(T1._TIME_SCALE),
            "--od-rate", repr(row.od_rate), "--spot-rate", repr(row.spot_rate),
            "--spin-up-s", repr(row.spin_up_s)]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = report.main(argv)
    _check(rc in (0, 1) and not err.getvalue()
           and "estimated $" in out.getvalue(),
           f"report validate on the row's counts: exit {rc}, "
           f"{out.getvalue()!r} {err.getvalue()!r}")
    for line in out.getvalue().splitlines():
        print(f"[report] validate (exit {rc}): {line}")


def _forecast_sweep():
    """The sweep's grid serial, then over a spawned pool with CUDA up in
    this process: the two result lists must be equal, and the pool must
    finish in `SWEEP_LIMIT_S` (an alarm ends a hung pool, whose context
    manager then terminates its workers)."""
    import signal
    from repro_torch import sweep

    specs = sweep.build_grid(**SWEEP_GRID)
    t0 = time.perf_counter()
    serial = sweep.run_sweep(specs, parallel=False)
    t_serial = time.perf_counter() - t0

    def _alarm(signum, frame):
        raise TimeoutError(f"the sweep's pool ran past {SWEEP_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(SWEEP_LIMIT_S)
    t0 = time.perf_counter()
    try:
        par = sweep.run_sweep(specs, parallel=True, processes=FORECAST_POOL)
    except TimeoutError as e:
        _fail(str(e))
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    t_par = time.perf_counter() - t0
    _check(par == serial, "the sweep's spawned pool and its serial run "
           "give different results")
    rep = sweep.build_report(specs, serial)
    print(f"[forecast] sweep of {len(specs)} cells (2 policies x 2 markets x "
          f"2 seeds): serial {t_serial:.2f} s, spawned pool of "
          f"{FORECAST_POOL} {t_par:.2f} s, results equal")
    for line in sweep.ranking_table(rep).splitlines():
        print(f"[forecast] {line}")


def _forecast_benchmarks():
    """The port's two forecast benchmarks, each with its own asserts;
    their CSV goes to `[forecast]` lines."""
    from repro_torch.benchmarks import forecast_prewarm, forecast_quality
    for bench in (forecast_quality, forecast_prewarm):
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                bench.main([])
        except AssertionError as e:
            _fail(f"{bench.__name__}: {e}")
        for line in out.getvalue().splitlines():
            print(f"[forecast] {bench.__name__.rsplit('.', 1)[-1]}: {line}")


def phase_forecast_report():
    """The real-training Table I row under the learned forecast policy
    at phi3-mini-3.8b's main path, int8 arm, its event log checked by the
    port's report; then the report's budget screen of the row, a sweep
    over a spawned pool and the two forecast benchmarks. Returns the
    row's launches, its RunResult and the path of its event log."""
    from repro_torch.benchmarks import table1 as T1
    from repro_torch.cloud.report import (RECONCILE_TOL, reconcile_path,
                                          render_summary, summarize_path)
    from repro_torch.forecast import register_learned_policy
    from repro_torch.models import lm

    t0 = time.perf_counter()
    arch = "phi3-mini-3.8b"
    cfg = T1.main_path(arch)[0]
    row = next(r for r in T1.ROWS if r.dataset == REAL_ROW)
    pol = register_learned_policy()
    log = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "learned_forecast.events.jsonl")
    gc.collect()
    counters = _reset_counters()
    res, hooks, cal = T1.run_real(row, policy=pol.name, rounds=REAL_ROUNDS,
                                  n_clients=len(CLIENTS), quantize=True,
                                  record_to=log, model=arch, device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    final_loss = hooks.final_loss()
    del hooks
    gc.collect()
    _check([sorted(r) for r in res.per_round_participants]
           == [sorted(CLIENTS)] * REAL_ROUNDS,
           f"learned row: participants {res.per_round_participants}")
    want = _expected_launches(
        cfg, len(lm.param_shapes(cfg)),
        train_rounds=T1.CAL_WARMUP + T1.CAL_ITERS + 1 + REAL_ROUNDS,
        codec_updates=REAL_ROUNDS * len(CLIENTS))
    print(f"[forecast] {cfg.name} learned row: launches {launches}")
    _check(launches == want, f"learned row: launched {launches}, want {want}")
    _check(math.isfinite(final_loss) and res.comm_cost > 0,
           f"learned row: final loss {final_loss}, egress ${res.comm_cost}")

    with open(log) as f:
        text = f.read()
    n_forecasts = text.count('"type": "ForecastUpdated"')
    rec = reconcile_path(log)
    summary = summarize_path(log)
    _check(rec.ok and abs(rec.delta) <= RECONCILE_TOL,
           f"learned row: reconcile failed: {rec.first_divergence}")
    _check(abs(summary["totals"]["total"] - res.total_cost) <= 1e-9,
           f"learned row: the report sums ${summary['totals']['total']!r}, "
           f"the run billed ${res.total_cost!r}")
    _check(n_forecasts > 0, "learned row: no ForecastUpdated record")
    print(f"[forecast] {cfg.name} learned row: calibrated epoch "
          f"{cal.mean_epoch_s(T1._TIME_SCALE)!r} s (measured round "
          f"{cal.measured_round_s!r} s x{T1._TIME_SCALE:g}); {REAL_ROUNDS} "
          f"rounds cost ${res.total_cost!r} (egress ${res.comm_cost!r}, "
          f"checkpoint ${res.checkpoint_cost!r}), makespan "
          f"{res.makespan_s!r} s, final loss {final_loss!r}; "
          f"{n_forecasts} ForecastUpdated records; reconciled, delta "
          f"{rec.delta!r} (tolerance {RECONCILE_TOL:g})")
    for line in render_summary(summary).splitlines():
        print(f"[report] {line}")

    want_res, want_log = _learned_stub_run(cfg, cal, row)
    _check(abs(res.total_cost - want_res.total_cost) <= 1e-9
           and abs(res.comm_cost - want_res.comm_cost) <= 1e-9,
           f"learned row: card ${res.total_cost!r}, CPU stub "
           f"${want_res.total_cost!r}")
    _check(text == want_log, "learned row: the card's event log differs "
           "from the CPU stub's")
    print(f"[forecast] {cfg.name} learned row: equal to the CPU runner's "
          f"with a payload-only stub and the card's calibrated profiles "
          f"(to 1e-9), event log of {len(text.encode())} bytes equal byte "
          f"for byte")

    _forecast_validate(cal, row, res)
    _forecast_sweep()
    _forecast_benchmarks()
    print(f"[times] phase_forecast_report: {time.perf_counter() - t0:.1f} s")
    return launches, res, log


def _stdout(fn, *args):
    """What `fn(*args)` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def _bench_renders(res, log):
    """The port's fig5 and fig4 over the learned row's event log, which
    the card recorded: fig5's last round holds each client's dollars and
    its total the run's, at its printed precision and to 1e-9; each
    client's fig4 states tile its timeline, which ends with the run's
    last round, before the makespan by less than one forecast poll (the
    simulator drains the poll armed before the run ended)."""
    from repro_torch.benchmarks import fig4_timeline as F4
    from repro_torch.benchmarks import fig5_costs as F5
    from repro_torch.forecast.strategy import LearnedForecastSpec

    text5 = _stdout(F5.main, ["--replay", log])
    rounds, clients, table, _, _ = F5.run(replay=log)
    final = {c: table[c][rounds[-1]] for c in clients}
    _check(sorted(final) == sorted(res.per_client_cost) and all(
        f"{final[c]:.4f}" == f"{res.per_client_cost[c]:.4f}"
        and abs(final[c] - res.per_client_cost[c]) <= 1e-9 for c in final),
           f"fig5's last round {final}, the run's {res.per_client_cost}")
    total = f"# total = ${res.total_cost:.4f}"
    _check(total in text5.splitlines()
           and abs(sum(final.values()) - res.total_cost) <= 1e-9,
           f"fig5 prints {text5.splitlines()[-1]!r}, the run billed "
           f"${res.total_cost!r}")
    print(f"[bench] fig5 over the card's log: the last round's dollars "
          f"equal the run's per_client_cost and its total the run's "
          f"${res.total_cost!r} (egress ${res.comm_cost!r} included: each "
          f"client's cost holds its own), to 4 decimals and to 1e-9")
    for line in text5.splitlines():
        print(f"[bench] fig5: {line}")

    text4 = _stdout(F4.main, ["--replay", log])
    _, by_client, totals, _ = F4.run(replay=log)
    ends = {}
    for c, segs in by_client.items():
        tiled = segs[0].t0 == 0.0 and all(
            a.t1 == b.t0 for a, b in zip(segs, segs[1:]))
        span = sum(v for (cc, _), v in totals.items() if cc == c)
        _check(tiled and abs(span - segs[-1].t1) <= 1e-6,
               f"fig4: {c}'s states sum to {span} s over a timeline to "
               f"{segs[-1].t1} s (tiled: {tiled})")
        ends[c] = segs[-1].t1
    end = max(ends.values())
    poll = LearnedForecastSpec().poll_s
    _check(sorted(ends) == sorted(res.per_client_cost)
           and all(abs(e - end) <= 1e-6 for e in ends.values())
           and 0.0 <= res.makespan_s - end < poll,
           f"fig4: timelines end at {ends}, makespan {res.makespan_s} s")
    print(f"[bench] fig4 over the card's log: each client's states sum to "
          f"its timeline, {end!r} s, the end of the last round; makespan "
          f"{res.makespan_s!r} s (the simulator drains the forecast poll "
          f"armed before the end, every {poll:g} s)")
    for line in text4.splitlines():
        print(f"[bench] fig4: {line}")


def _bench_roofline(rec):
    """The port's roofline report over the port's dry-run path, where
    `phase_mesh_fl` put the card's record: its row carries the record."""
    from repro_torch.benchmarks import roofline_report as RR

    lines = _stdout(RR.main).splitlines()
    key = f"{rec['arch']},{rec['shape']},{rec['mesh']},"
    rows = [line.split(",") for line in lines if line.startswith(key)]
    rl = rec["roofline"]
    want = [f"{rl['compute_s']:.4g}", f"{rl['memory_s']:.4g}",
            rl["dominant"], f"{rl['model_flops']:.3e}"]
    _check(lines[:1] == [RR.NOTE] and len(rows) == 1
           and [rows[0][i] for i in (4, 5, 7, 8)] == want,
           f"roofline report {lines}, want a row {key} carrying {want}")
    for line in lines:
        print(f"[bench] roofline: {line}")


def _bench_sections():
    """The section driver's runs (`repro_torch.benchmarks.expected.RUNS`)
    on this machine's host, from the checkout's root, each held to the
    JAX package's committed output; the scaling rows' and the
    accounting bench's wall seconds printed as host timings."""
    from repro_torch.benchmarks import expected as X

    root = os.path.dirname(os.path.abspath(__file__))
    with contextlib.chdir(root):
        for stem in X.STEMS:
            t0 = time.perf_counter()
            try:
                text = X.capture(stem)
            except AssertionError as e:
                _fail(f"{stem}: {e}")
            secs = time.perf_counter() - t0
            got, want = X.deterministic(text).splitlines(), \
                X.expected(stem).splitlines()
            bad = next((i for i, (a, b) in enumerate(zip(got, want))
                        if a != b), min(len(got), len(want)))
            _check(got == want, f"{stem}: line {bad + 1} reads "
                   f"{got[bad:bad + 1]}, the JAX package's "
                   f"{want[bad:bad + 1]}")
            print(f"[bench] {stem}: {len(got)} lines equal to "
                  f"tests/torch_expected/benchmarks/{stem}.txt; {secs:.2f} s "
                  f"(host clock)")
            if stem in ("scaling", "accounting_bench"):
                for line in text.splitlines():
                    print(f"[bench] {stem} (host timings of the card's "
                          f"machine): {line}")


def phase_benchmarks(res, log, dry_rec):
    """The port's benchmarks on this machine: fig4 and fig5 over the
    learned row's log that the card recorded (`phase_forecast_report`,
    whose RunResult is `res`), the roofline report over the card's
    dry-run record `dry_rec` (`phase_mesh_fl`), and the section driver's
    runs held to the JAX package's output. No kernel runs."""
    t0 = time.perf_counter()
    counters = _reset_counters()
    _bench_renders(res, log)
    _bench_roofline(dry_rec)
    _bench_sections()
    launches = {name: fn.launches for name, fn in counters.items()}
    _check(not any(launches.values()),
           f"the benchmarks launched the port's kernels: {launches}")
    print(f"[bench] launches of the port's kernels during the phase: "
          f"{launches}")
    print(f"[times] phase_benchmarks: {time.perf_counter() - t0:.1f} s")


# Card-against-CPU bar of one SMOKE round, per leaf: a share of the
# leaf's update on the CPU plus 2 ulps of its largest entry, and a leaf
# that moved by more than an ulp on the CPU must move on the card. The
# share is 2% but for recurrentgemma SMOKE, which is ill-conditioned in
# fp32 (ROADMAP §3): its zero-initialised biases come out a few percent
# of their update apart between card and CPU, while on the card the
# gradients through its kernels agree with those through their plain
# versions to 1e-4 (tests/test_torch_cuda.py)
SMOKE_SHARE = {"recurrentgemma-2b": 1e-1}
# The round's lr: the hooks' default 5e-3, but 2e-4 (the CPU tests' lr)
# for the SMOKE configs added with the other LM families. At 5e-3 the
# first step moves the 0.02-scale embeddings about tenfold, and two
# correct fp32 runs then part ways within the round: the JAX package
# and the port on the CPU land 2.07 to 2.26 of the bar apart for
# granite-moe and dbrx (the router's softmax turns the embeddings'
# rounding into gate changes) and 0.78 to 0.99 for glm4, command-r, qwen
# and musicgen; at 2e-4, 0.19 to 0.39 (`tools/lm_fp32_spread.py --rounds
# --lr ... --seq 64 --schedule one_round`)
SMOKE_LR = {arch: 2e-4 for arch in (
    "glm4-9b", "command-r-35b", "qwen1.5-110b", "granite-moe-3b-a800m",
    "dbrx-132b", "musicgen-medium")}
# llama-3.2-vision-90b SMOKE: its cross-attention layers need a `cond`
# batch, which the hooks do not draw, so one fp32 loss and gradient on
# the card is held to the CPU's: the loss to 1e-5 of itself, each leaf's
# gradient to 3e-3 of its largest entry, the bar of
# tests/test_torch_families.py (its one stacked block of five std-1
# layers amplifies fp32 rounding: two correct fp32 runs lie up to 2.2e-3
# apart, tools/lm_fp32_spread.py)
VLM, VLM_GRAD_TOL = "llama-3.2-vision-90b", 3e-3


def phase_small_reference(arch):
    """A SMOKE-size run on the card against the same run on the CPU."""
    from repro_torch.common.bridge import flatten_with_paths
    from repro_torch.fl.training import TorchTrainerHooks

    share = SMOKE_SHARE.get(arch, 2e-2)
    lr = SMOKE_LR.get(arch, LR)
    for quantize in (False, True):
        runs = []
        for device in ("cuda", "cpu"):
            # one round at the default lr (`SMOKE_LR` aside): at a much
            # smaller lr a parameter's fp32 ulp is a sizeable share of
            # its update, and over more rounds the rounding differences
            # between two correct runs grow until they part ways
            hooks = TorchTrainerHooks(CLIENTS, model=arch, smoke=True,
                                      local_steps=2, batch=2, seq=64, lr=lr,
                                      quantize=quantize, device=device)
            init = {k: v.cpu() for k, v in flatten_with_paths(hooks.params)}
            _fl_run(hooks, quantize)
            runs.append(({k: v.cpu() for k, v in
                          flatten_with_paths(hooks.params)},
                         [r["mean_loss"] for r in hooks.losses]))
        (gpu, gpu_loss), (cpu, cpu_loss) = runs
        _check(max(abs(a - b) for a, b in zip(gpu_loss, cpu_loss)) <= 2e-4,
               f"{arch} SMOKE losses card {gpu_loss} vs CPU {cpu_loss}")
        worst, leaf = 0.0, None
        for k in cpu:
            update = (cpu[k] - init[k]).abs().max().item()
            err = (gpu[k] - cpu[k]).abs().max().item()
            ulp = torch.finfo(cpu[k].dtype).eps * cpu[k].abs().max().item()
            bar = share * update + 2 * ulp
            _check(update <= ulp or not torch.equal(gpu[k], init[k]),
                   f"{arch} SMOKE: {k} did not move on the card, by "
                   f"{update:.3e} on the CPU")
            _check(err <= bar, f"{arch} SMOKE params card vs CPU: {k} off "
                   f"by {err:.3e}, update {update:.3e}, bar {bar:.3e}")
            if err > 0 and err / bar >= worst:
                worst, leaf = err / bar, k
        print(f"[reference] {arch} SMOKE quantize={quantize} lr {lr:g}: card "
              f"vs CPU "
              f"loss {gpu_loss} vs {cpu_loss}; params within {worst:.3f} of "
              f"the bar ({leaf}; bar {share:g} of the leaf's update + 2 "
              f"ulps)")


def phase_vlm_reference():
    """llama-3.2-vision-90b SMOKE's loss and gradients on a batch with
    `cond`, on the card (its four self-attention layers on the fp32 flash
    kernel at head dim 8, its cross layer plain) against the CPU."""
    from repro_torch import configs
    from repro_torch.common.bridge import flatten_with_paths, unflatten
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import lm

    cfg = configs.get_config(VLM, smoke=True)
    params = dict(flatten_with_paths(lm.init_params(cfg, 0, "cpu")))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "cond": torch.randn(2, cfg.n_cond_tokens, cfg.d_model,
                                 generator=gen)}
    runs = {}
    for device in ("cuda", "cpu"):
        leaves = {k: v.to(device).requires_grad_() for k, v in params.items()}
        before = fa.flash_attention_fwd.launches
        loss = lm.loss_fn(unflatten(leaves), cfg,
                          {k: v.to(device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(leaves.values()))
        runs[device] = (loss.item(), {k: g.cpu() for k, g in
                                      zip(leaves, grads)},
                        fa.flash_attention_fwd.launches - before)
    (gpu_loss, gpu, launched), (cpu_loss, cpu, _) = runs["cuda"], runs["cpu"]
    want = cfg.pattern.count("attn") * cfg.n_super
    _check(launched == want, f"{VLM} SMOKE: {launched} flash launches on the "
           f"card, want {want}")
    _check(abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss),
           f"{VLM} SMOKE loss card {gpu_loss!r}, CPU {cpu_loss!r}")
    ratios = {k: (gpu[k] - g).abs().max().item()
              / (VLM_GRAD_TOL * g.abs().max().item()) for k, g in cpu.items()}
    worst, leaf = _worst(ratios)
    _check(worst <= 1, f"{VLM} SMOKE gradient card vs CPU: {leaf} at "
           f"{worst:.3f} of the bar")
    print(f"[reference] {VLM} SMOKE with a cond batch, one fp32 loss and "
          f"gradient: card vs CPU loss {gpu_loss!r} vs {cpu_loss!r}; "
          f"gradients within {worst:.3f} of the bar ({leaf}; "
          f"{VLM_GRAD_TOL:g} of the leaf's largest entry); {launched} flash "
          f"launches (fp32, head dim {cfg.resolved_head_dim})")


# The decode path and the drivers (`repro_torch.launch`). `phase_serve`
# runs the serving driver at each LM main path's full width and depth, in
# the path's bf16, for its times and launches: a prompt of `SERVE_PROMPT`
# tokens prefilled by decode steps, then `SERVE_GEN` greedy tokens;
# recurrentgemma-2b's prompt passes its window of 2048, so its local
# attention's ring buffer wraps. The decode's arithmetic is held in fp32
# at the same shapes and weights: the teacher-forced logits at every
# prompt position against `lm.forward`'s on the card (its fp32 kernels),
# max |decode - forward| over the largest forward logit, within
# `DECODE_BAR` (each bar lies between the card's fp32 reading of a
# correct decode and that of a faulty one: PERF.md §6, PR 19). The fp32
# run takes the bf16 weights upcast. In bf16 two correct computations at
# random weights lie up to 0.17 (phi3) and 0.63 (granite) of the largest
# logit apart (`tools/decode_card_spread.py`), so no bf16 bar tells a
# fault from rounding. The ring's check has its own teeth:
# recurrentgemma's decode against a forward whose window is one key
# short (a ring that drops its oldest key) must read over the bar past
# the window; against one a key long it is printed, not held (a key
# that far back moved the logits within rounding at these weights; the
# SMOKE window of 8 holds both directions in the CPU tests).
# granite-moe's router has near-ties that two correct fp32 computations
# break either way (the card and the CPU 0.111 of the largest logit apart
# at batch 4 x 256), and an expert chosen otherwise moves its position
# and, through the next layers' attention, every later position of its
# row; so its gap is read at the (row, position) pairs where the decode
# and the forward chose the same experts in every layer and no earlier
# position of the row chose otherwise in a layer before the last, and
# the share of pairs choosing otherwise is held under `ROUTE_FLIPS`; its
# forward takes the capacity factor E/K (no drops), as a decode step's
# group of B tokens never fills an expert's capacity. Its random weights
# leave it ill-conditioned (a peaked router over experts whose outputs
# grow large), so fp32 rounding grows through its two layers to a heavy
# tail of a few positions, with no expert chosen otherwise there: its
# bar is the widest, a tenth of the largest logit
SERVE_PROMPT = {"phi3-mini-3.8b": 1024, "mamba2-1.3b": 1024,
                "recurrentgemma-2b": 2100, "granite-moe-3b-a800m": 1024}
SERVE_GEN = 32
DECODE_BAR = {"phi3-mini-3.8b": 5e-3, "mamba2-1.3b": 5e-3,
              "recurrentgemma-2b": 1e-3, "granite-moe-3b-a800m": 1e-1}
ROUTE_FLIPS = 1e-2
# `phase_train`: phi3-mini-3.8b's main path through the training driver,
# two micro-batches a step (adamw, weight decay 0.1, train.py's lr),
# `TRAIN_STEPS` steps uninterrupted and in two runs: to a checkpoint at
# step `TRAIN_CKPT`, then resumed there. The resumed run's parameters and
# optimizer state are held to the uninterrupted run's within 2 ulps of
# each leaf's largest entry: two uninterrupted runs on the card were bit
# for bit equal in each of five calls (PERF.md §6, PR 19), and the
# driver switches on no deterministic mode
TRAIN_ARCH, TRAIN_ACCUM, TRAIN_LR = "phi3-mini-3.8b", 2, 1e-3
TRAIN_STEPS, TRAIN_CKPT = 6, 3
# One `make_train_step` step (two micro-batches) of these SMOKE configs on
# the card against the CPU, batch 4 x 64, at `SMOKE_LR` and 2% of each
# leaf's update plus 2 ulps. Each leaf's first moments (a tenth of its
# clipped fp32 gradient) are held at `STEP_GRAD_X` times that leaf's own
# fp32 distance from a float64 run of the same step on the CPU (over the
# leaf's largest entry), and at least the CPU parity tests' gradient bar
# (`STEP_GRAD_FLOOR`, tests/test_torch_models.py's GRAD_TOL): at batch
# 4 x 64 the worst leaf's distance is 2.2e-4 for phi3, 8.3e-5 mamba2,
# 1.3e-3 recurrentgemma (`conv_b`, which missed 1e-4 and 1e-3 on the
# card) and 3.3e-4 granite-moe; recurrentgemma's `ra_w` leaves lie 1e-5
# and 5e-5 from float64 on the CPU but 1.6e-4 and 3.2e-4 from the CPU on
# the card (the fused RG-LRU backward sums in another order)
STEP_ARCHS = ("phi3-mini-3.8b", "mamba2-1.3b", "recurrentgemma-2b",
              "granite-moe-3b-a800m")
STEP_GRAD_X = 4
STEP_GRAD_FLOOR = {"recurrentgemma-2b": 1e-3}
STEP_SHARE = 2e-2


def _layer_launches(cfg, *kinds):
    return sum(cfg.pattern.count(k) for k in kinds) * cfg.n_super + sum(
        cfg.tail_pattern.count(k) for k in kinds)


def _forward_launches(cfg):
    """What one forward (no gradient) launches: each layer's kernel once."""
    want = {name: 0 for name in _counters()}
    want["flash_attention_fwd"] = _layer_launches(cfg, "attn", "local_attn")
    want["ssd_fwd"] = _layer_launches(cfg, "mamba2")
    want["rglru_scan_fwd"] = _layer_launches(cfg, "rglru")
    return want


def _launches(counters):
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters.items()}


@contextlib.contextmanager
def _expert_choices(out):
    """Records the expert indices of every MoE call in `out`, each as
    (tokens, K) in the order of the layer's (B, S) tokens, sorted."""
    from repro_torch.models import layers

    real = layers.top_k

    def top_k(x, k):
        vals, idx = real(x, k)
        out.append(idx.reshape(-1, k).sort(dim=-1).values)
        return vals, idx

    layers.top_k = top_k
    try:
        yield
    finally:
        layers.top_k = real


def _gap(dec, ref):
    """Each (row, position)'s max |dec - ref| over ref's largest entry."""
    return (dec - ref).abs().amax(-1) / ref.abs().max()


def _decode_vs_forward(arch, cfg, params, batch, P):
    """The serving driver in fp32 at `cfg`'s width and depth with its
    prompt kept: its teacher-forced logits against the forward's on the
    kernels. Returns the gap, the bar and the printed readings; fails
    past a bar."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    c = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    if c.moe:
        m = c.moe
        c = dataclasses.replace(c, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    routes = []
    with _expert_choices(routes) if c.moe else contextlib.nullcontext():
        out = serve.serve(c, params, batch, P, 1, device="cuda",
                          keep_prompt_logits=True, log=lambda s: None)
        counters = _reset_counters()
        with torch.no_grad():
            full, _ = lm.forward(params, c, out["prompt"])
        launches = _launches(counters)
    _check(launches == _forward_launches(c),
           f"{c.name} fp32: forward launched {launches}")
    dec = out.pop("prompt_logits")
    _check(bool(torch.isfinite(dec).all()) and bool(torch.isfinite(full).all()),
           f"{c.name} fp32: non-finite logits")
    gap = _gap(dec, full)                                       # (B, P)
    bar = DECODE_BAR[arch]
    notes = [f"prefill by decode steps {out['prefill_s']:.1f} s"]
    keep = torch.ones_like(gap, dtype=torch.bool)
    if c.moe:
        # each decode step records its layers' (B, K), then the forward
        # its layers' (B * P, K)
        n = len(routes) // (P + 2)
        dec_r = torch.stack(routes[:P * n]).reshape(P, n, batch, -1)
        fwd_r = torch.stack(routes[-n:]).reshape(n, batch, P, -1)
        same = (dec_r.permute(2, 0, 1, 3) == fwd_r.permute(1, 2, 0, 3)
                ).all(-1)                                       # (B, P, n)
        later = (~same[..., :-1]).any(-1).int().cummax(-1).values.bool()
        keep = same.all(-1) & ~later
        flips = 1 - same.all(-1).float().mean().item()
        notes.append(f"expert choices differ at {int((~same.all(-1)).sum())} "
                     f"of {keep.numel()} (row, position) pairs ({flips:.3%}, "
                     f"bar {ROUTE_FLIPS:.0%}); read at the {int(keep.sum())} "
                     f"pairs neither they nor an earlier flip reach; at "
                     f"every pair {gap.max().item():.3e}")
        _check(flips <= ROUTE_FLIPS, f"{c.name} fp32: expert choices differ "
               f"at {flips:.3%} of the pairs, bar {ROUTE_FLIPS:.0%}")
    worst = gap[keep].max().item()
    _check(worst <= bar, f"{c.name}: fp32 teacher-forced decode lies "
           f"{worst:.3e} of the largest logit from forward, bar {bar:.3e}")
    if "local_attn" in c.pattern:
        W = c.window_size
        _check(P > W, f"{c.name}: the ring does not wrap at prompt {P}")
        notes.append(f"before the wrap {gap[:, :W].max().item():.3e}, "
                     f"after it {gap[:, W:].max().item():.3e}")
        for w in (W - 1, W + 1):
            with torch.no_grad():
                other, _ = lm.forward(params, dataclasses.replace(
                    c, window_size=w), out["prompt"])
            wrong = _gap(dec[:, W:], other[:, W:]).max().item()
            _check(w > W or wrong > bar, f"{c.name}: the decode lies "
                   f"{wrong:.3e} of the largest logit from a forward with "
                   f"window {w}, under the bar {bar:.3e}")
            notes.append(f"against a forward with window {w} (a ring a "
                         f"key {'long, not held' if w > W else 'short'}) "
                         f"{wrong:.3e} past the window")
    return worst, bar, notes


def phase_serve(arch):
    """The serving driver at one main path's full width (see above)."""
    from repro_torch.benchmarks.table1 import main_path
    from repro_torch.common.bridge import tree_map
    from repro_torch.launch import serve, steps
    from repro_torch.models import lm

    cfg, batch, _ = main_path(arch)
    P = SERVE_PROMPT[arch]
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, 0, "cuda")
    counters = _reset_counters()
    out = serve.serve(cfg, params, batch, P, SERVE_GEN, device="cuda",
                      log=lambda s: print(f"[serve] {cfg.name}: {s}"))
    decode_launches = _launches(counters)
    _check(not any(decode_launches.values()),
           f"{cfg.name}: the decode loop launched {decode_launches}")
    _check(out["tokens"].shape == (batch, SERVE_GEN)
           and bool(((out["tokens"] >= 0)
                     & (out["tokens"] < cfg.vocab_size)).all()),
           f"{cfg.name}: tokens of shape {tuple(out['tokens'].shape)}")

    counters = _reset_counters()
    with torch.no_grad():
        full, _ = lm.forward(params, cfg, out["prompt"])
    fwd_launches = _launches(counters)
    prefill = steps.make_prefill_step(cfg)
    counters = _reset_counters()
    last = prefill(params, out["prompt"])
    prefill_launches = _launches(counters)
    want = _forward_launches(cfg)
    _check(fwd_launches == want and prefill_launches == want,
           f"{cfg.name}: forward launched {fwd_launches}, prefill "
           f"{prefill_launches}, want {want}")
    _check(torch.equal(last, full[:, -1]) and bool(torch.isfinite(last).all()),
           f"{cfg.name}: make_prefill_step differs from forward's last row")
    prefill_ms = _time_ms(lambda: prefill(params, out["prompt"]), iters=3,
                          warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del full, last
    params = tree_map(lambda t: t.float(), params)
    gc.collect()
    gap, bar, notes = _decode_vs_forward(arch, cfg, params, batch, P)
    ms_tok = out["decode_s"] / SERVE_GEN * 1e3
    print(f"[serve] {cfg.name} ({cfg.num_layers} layers, batch {batch}, "
          f"prompt {P}, {SERVE_GEN} greedy tokens, bf16): teacher-forced "
          f"prefill {out['prefill_s'] * 1e3:.1f} ms ({out['prefill_s'] / P * 1e3:.3f} "
          f"ms a position), decode {ms_tok:.3f} ms/token "
          f"({batch / ms_tok * 1e3:.1f} tokens/s); make_prefill_step "
          f"{prefill_ms:.3f} ms (CUDA events); peak {peak:.2f} GB; "
          f"{_gpu_name()}")
    print(f"[serve] {cfg.name}: fp32 teacher-forced decode vs forward at "
          f"all {P} prompt positions: {gap:.3e} of the largest logit, bar "
          f"{bar:.3e}; " + "; ".join(notes) + f"; launches: decode loop "
          f"{decode_launches}, forward and prefill {want}; prefill step "
          f"equal to forward's last row bit for bit; phase "
          f"{time.perf_counter() - t0:.1f} s")


# Every registry config's SMOKE decode on the card against the CPU in
# fp32: 16 steps, batch 2 (recurrentgemma SMOKE's window is 8, so its
# ring wraps), the logits after each step within `STEP_GRAD_X` times the
# CPU's own fp32 distance from a float64 run of the same decode (max
# |difference| over the largest logit), and at least 5e-5, the bar of
# the seven families' logits parity (tests/test_torch_decode.py): at
# 2e-5 absolute and relative, phi3's held for the JAX package on the
# CPU, the card missed (1.32 of it)
DECODE_SMOKE_STEPS = 16


def _decode_logits(cfg, device, toks, cond, f64=False):
    """`DECODE_SMOKE_STEPS` teacher-forced decode steps of `cfg`'s seed-0
    weights (in float64, cache included, with `f64`), logits on the CPU."""
    from repro_torch.common import config as C
    from repro_torch.common.bridge import tree_map
    from repro_torch.common.float64 import float_is_double
    from repro_torch.models import lm

    B, S = toks.shape[:2]
    params = lm.init_params(cfg, 0, device)
    cache = lm.init_cache(cfg, B, S, device=device)
    toks, cond = toks.to(device), cond.to(device)
    if f64:
        params, cache = (tree_map(lambda t: t.double(), x)
                         for x in (params, cache))
        cfg = dataclasses.replace(cfg, dtype="float64", param_dtype="float64")
        toks = toks.double() if toks.is_floating_point() else toks
        cond = cond.double()
    with float_is_double() if f64 else contextlib.nullcontext():
        for i, kind in enumerate(cfg.pattern):
            if kind == C.CROSS_ATTN:
                key = f"{i:02d}_{kind}"
                mix = params["blocks"][key]["mix"]
                cache["blocks"][key]["cond_k"].copy_(
                    torch.einsum("btd,ldnh->lbtnh", cond, mix["wk"]))
                cache["blocks"][key]["cond_v"].copy_(
                    torch.einsum("btd,ldnh->lbtnh", cond, mix["wv"]))
        out = []
        for t in range(S):
            logits, cache = lm.decode_step(
                params, cfg, toks[:, t:t + 1],
                torch.full((B,), t, device=device), cache)
            out.append(logits[:, 0].cpu().double())
    return torch.stack(out, dim=1)


def phase_decode_smoke():
    """The decode path's arithmetic at SMOKE size in fp32, card against
    CPU, for the ten configs (vlm with its cross layers' keys and values
    of a random `cond` in the cache, musicgen on frames)."""
    from repro_torch import configs

    B, S = 2, DECODE_SMOKE_STEPS
    worst = {}
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, smoke=True)
        gen = torch.Generator().manual_seed(1)
        if cfg.family == "audio":
            toks = torch.randn(B, S, cfg.d_model, generator=gen)
        else:
            toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
        cond = torch.randn(B, cfg.n_cond_tokens, cfg.d_model, generator=gen)
        got = _decode_logits(cfg, "cuda", toks, cond)
        want = _decode_logits(cfg, "cpu", toks, cond)
        f64 = _decode_logits(cfg, "cpu", toks, cond, f64=True)
        top = want.abs().max().item()
        spread = (want - f64).abs().max().item() / top
        tol = max(STEP_GRAD_X * spread, 5e-5)
        ratio = (got - want).abs().max().item() / (tol * top)
        _check(ratio <= 1, f"{arch} SMOKE decode card vs CPU: {ratio:.3f} of "
               f"the bar {tol:.3e} of the largest logit (the CPU's fp32 "
               f"distance from float64 {spread:.3e})")
        worst[arch] = (round(ratio, 3), f"{tol:.1e}")
    print(f"[serve] SMOKE decode, {S} steps of batch {B} in fp32, card vs "
          f"CPU logits: each config's share of its bar, and the bar (of the "
          f"largest logit: {STEP_GRAD_X} x the CPU's fp32 distance from "
          f"float64, at least 5e-5): {worst}")


def phase_train():
    """The training driver at phi3-mini-3.8b's main path: an uninterrupted
    run, a run that stops at its one checkpoint, and a run that resumes
    there and saves none; the resumed parameters and optimizer state held
    to the uninterrupted run's (see `TRAIN_STEPS`)."""
    import tempfile
    from repro_torch.benchmarks.table1 import main_path
    from repro_torch.common.bridge import flatten_with_paths
    from repro_torch.launch import train

    cfg, batch, seq = main_path(TRAIN_ARCH)
    cfg = dataclasses.replace(cfg, grad_accum=TRAIN_ACCUM)
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()

    def run(steps, ckpt_dir=""):
        """A run of the driver; its final state as flat fp32 leaves. Each
        step's micro-batches launch flash once a layer in the forward and
        once in the backward's recompute (remat), nothing else. A run
        with `ckpt_dir` saves at step `TRAIN_CKPT` only (a checkpoint
        of 4.2 GB takes seconds on the host each way)."""
        counters = _reset_counters()
        t0 = time.perf_counter()
        out = train.train(cfg, TRAIN_ARCH, steps, batch, seq, TRAIN_LR,
                          ckpt_dir=ckpt_dir, ckpt_every=(
                              TRAIN_CKPT if steps == TRAIN_CKPT
                              else TRAIN_STEPS + 1),
                          log_every=TRAIN_STEPS, device="cuda",
                          log=lambda s: print(f"[train] {cfg.name}: {s}"))
        out["wall_s"] = time.perf_counter() - t0
        launches = _launches(counters)
        want = {name: 0 for name in counters}
        want["flash_attention_fwd"] = ((steps - out["start_step"])
                                       * TRAIN_ACCUM * (1 + cfg.remat)
                                       * _layer_launches(cfg, "attn"))
        _check(launches == want, f"{cfg.name} train to step {steps}: "
               f"launched {launches}, want {want}")
        out["launches"] = launches["flash_attention_fwd"]
        state = {"params": out.pop("params"), "opt": out.pop("opt")}
        if steps == TRAIN_STEPS:
            out["flat"] = {k: v.float()
                           for k, v in flatten_with_paths(state)}
        return out

    whole = run(TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as d:
        first = run(TRAIN_CKPT, d)
        resumed = run(TRAIN_STEPS, d)
    losses = whole["losses"]
    _check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses))
           and resumed["start_step"] == TRAIN_CKPT
           and len(first["losses"]) + len(resumed["losses"]) == TRAIN_STEPS,
           f"{cfg.name} train: losses {losses}, resumed at "
           f"{resumed['start_step']}")
    worst, leaf = 0.0, None
    for k, w in whole["flat"].items():
        err = (resumed["flat"][k] - w).abs().max().item()
        bar = 2 * torch.finfo(torch.bfloat16 if k.startswith("params/")
                              else torch.float32).eps * w.abs().max().item()
        _check(err <= bar, f"{cfg.name} resumed vs uninterrupted: {k} off by "
               f"{err:.3e}, bar {bar:.3e} (2 ulps of its largest entry)")
        if err > 0 and err / bar >= worst:
            worst, leaf = err / bar, k
    exact = all(torch.equal(resumed["flat"][k], w)
                for k, w in whole["flat"].items())
    step_s = sorted(whole["step_s"][1:])
    med = step_s[len(step_s) // 2]
    print(f"[train] {cfg.name} ({cfg.num_layers} layers, batch {batch} x "
          f"{seq}, grad_accum {TRAIN_ACCUM}, adamw lr {TRAIN_LR:g} wd 0.1): "
          f"losses {losses}; resumed losses {resumed['losses']}; "
          f"{med * 1e3:.1f} ms/step (median of steps 2-{TRAIN_STEPS}, host "
          f"clock), {batch * seq / med:.0f} tokens/s; runs of {whole['wall_s']:.1f} "
          f"s uninterrupted, {first['wall_s']:.1f} s to the checkpoint, "
          f"{resumed['wall_s']:.1f} s resumed; flash launches "
          f"{whole['launches']}, {first['launches']} and "
          f"{resumed['launches']} (6, 3 and 3 steps); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {_gpu_name()}")
    print(f"[train] {cfg.name}: resumed vs uninterrupted "
          + ("bit for bit" if exact else
             f"within {worst:.3f} of the bar ({leaf})")
          + f" (bar: 2 ulps of each leaf's largest entry); phase "
          f"{time.perf_counter() - t0:.1f} s")


def phase_train_step_smoke(arch):
    """One `make_train_step` step with two micro-batches on the card
    against the CPU: the loss, each leaf's first moments (see
    `STEP_GRAD_X`), and each leaf within `STEP_SHARE` of its update plus
    2 ulps at the elements whose CPU first moment is 0 or lies over the
    leaf's bar (AdamW's first step moves an element by lr whatever its
    gradient's size, so an element whose gradient is rounding takes an
    unsettled step); how many elements each leaf leaves out is printed."""
    from repro_torch import configs
    from repro_torch.common.bridge import flatten_with_paths, tree_map
    from repro_torch.common.float64 import float_is_double
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              grad_accum=2)
    lr, floor = SMOKE_LR.get(arch, LR), STEP_GRAD_FLOOR.get(arch, 1e-4)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (4, 65), generator=gen)
    runs = {}
    for run in ("cuda", "cpu", "float64"):
        device = "cpu" if run == "float64" else run
        params = lm.init_params(cfg, 0, device)
        c, ctx = cfg, contextlib.nullcontext()
        if run == "float64":
            params = tree_map(lambda t: t.double(), params)
            c = dataclasses.replace(cfg, dtype="float64",
                                    param_dtype="float64")
            ctx = float_is_double()
        with ctx:
            step, opt = steps.make_train_step(c, lr=lr)
            new, state, m = step(params, opt.init(params),
                                 {"tokens": toks[:, :-1].to(device),
                                  "labels": toks[:, 1:].to(device)})
        runs[run] = (float(m["loss"]),
                     {k: v.cpu() for k, v in flatten_with_paths(new)},
                     {k: v.cpu().double() for k, v in
                      flatten_with_paths(state.mu)})
    init = dict(flatten_with_paths(lm.init_params(cfg, 0, "cpu")))
    (gpu_loss, gpu, gpu_mu), (cpu_loss, cpu, cpu_mu) = runs["cuda"], runs["cpu"]
    f64_mu = runs["float64"][2]
    _check(abs(gpu_loss - cpu_loss) <= 2e-4,
           f"{arch} SMOKE train step loss card {gpu_loss}, CPU {cpu_loss}")
    worst, leaf, gworst, gleaf, left_out, n_all = 0.0, None, 0.0, None, {}, 0
    for k, w in cpu.items():
        g = cpu_mu[k].abs()
        top = g.max().item()
        if top == 0:
            continue
        spread = (cpu_mu[k] - f64_mu[k]).abs().max().item() / top
        gtol = max(STEP_GRAD_X * spread, floor)
        gerr = (gpu_mu[k] - cpu_mu[k]).abs().max().item()
        _check(gerr <= gtol * top, f"{arch} SMOKE train step: {k} first "
               f"moment off by {gerr / top:.3e} of its largest, bar "
               f"{gtol:.3e} ({STEP_GRAD_X} x its CPU fp32 distance from "
               f"float64, {spread:.3e}, at least {floor:g})")
        if gerr / (gtol * top) >= gworst:
            gworst, gleaf = gerr / (gtol * top), f"{k}, bar {gtol:.1e}"
        update = (w - init[k]).abs().max().item()
        ulp = torch.finfo(w.dtype).eps * w.abs().max().item()
        bar = STEP_SHARE * update + 2 * ulp
        settled = (g > gtol * top) | (g == 0)
        n_all += g.numel()
        if not settled.all():
            left_out[k] = int((~settled).sum())
        err = (gpu[k] - w).abs()[settled]
        err = err.max().item() if err.numel() else 0.0
        _check(err <= bar, f"{arch} SMOKE train step: {k} off by {err:.3e}, "
               f"update {update:.3e}, bar {bar:.3e}")
        if err > 0 and err / bar >= worst:
            worst, leaf = err / bar, k
    print(f"[reference] {arch} SMOKE make_train_step (grad_accum 2, adamw lr "
          f"{lr:g}): card vs CPU loss {gpu_loss!r} vs {cpu_loss!r}; first "
          f"moments within {gworst:.3f} of their leaf's bar ({gleaf}; "
          f"{STEP_GRAD_X} x the leaf's CPU fp32 distance from float64, at "
          f"least {floor:g}); params within {worst:.3f} of the bar ({leaf}; "
          f"{STEP_SHARE:g} of the leaf's update + 2 ulps, where the first "
          f"moment is 0 or over its leaf's bar); left out "
          f"{sum(left_out.values())} of {n_all} elements: {left_out}")


# The paper's CNN path (`repro_torch.examples.paper_reproduction`): each
# Table I dataset's model at the data sizes the repo runs it at, and the
# phases that run it; "row" is the MNIST row in full (3 policies x 10
# epochs), "round" one FedCostAware round (sync engine), "epoch" a local
# epoch only
# FL in the mesh (`repro_torch/fl/mesh_fl.py`) at phi3-mini-3.8b's main
# path: C stacked clients of `LOCAL_STEPS` steps a round, weights [3, 1],
# at the hooks' lr. Their losses are held to `TorchTrainerHooks.
# _local_train`'s from the same start on the same batches within
# `MESH_LOSS_TOL` of the loss (the same ops in the same order on one card:
# no gap is expected, the bar leaves room for an atomic sum's order); the
# meta device's count of one local step is held to the card's: FLOPs and
# each kernel's work exactly, bytes within `MESH_BYTES_TOL` (the card's
# flash wrapper would copy a q, k or v that broke TMA's alignment, which
# the meta branch does not; at this path none does, and the bytes came
# out equal); phi3 SMOKE's round on the card is held to the
# CPU's at `MESH_SMOKE_LR`, the CPU tests' lr, with the multi-step bar of
# ROADMAP §3 (2% of each leaf's update plus 2 ulps)
MESH_ARCH, MESH_C, MESH_WEIGHTS = "phi3-mini-3.8b", 2, (3.0, 1.0)
MESH_LOSS_TOL, MESH_BYTES_TOL, MESH_SMOKE_LR = 1e-5, 1e-3, 2e-4


def _mesh_batches(cfg, batch, seq):
    """Each client's `LOCAL_STEPS` batches of the hooks' token streams,
    as the hooks draw them, and stacked as (C, LOCAL_STEPS, B, S)."""
    import numpy as np
    from repro_torch.benchmarks.table1 import LOCAL_STEPS
    from repro_torch.data.synthetic import token_stream
    rows = [[next(s) for _ in range(LOCAL_STEPS)] for s in (
        token_stream(cfg.vocab_size, batch, seq, seed=17 * i)
        for i in range(MESH_C))]
    return {k: np.stack([np.stack([r[k] for r in c]) for c in rows]
                        ).astype(np.int64) for k in ("tokens", "labels")}


def _stacked_round(cfg, params, batches, lr, device):
    """One `make_fl_round_step` round of the stacked clients from
    `params`: (aggregate, losses, round seconds on the host clock)."""
    from repro_torch.benchmarks.table1 import LOCAL_STEPS
    from repro_torch.common.bridge import tree_map
    from repro_torch.fl import mesh_fl
    stk = mesh_fl.stack_params_for_clients(params, MESH_C)
    mu = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=device), stk)
    b = {k: torch.from_numpy(v).to(device) for k, v in batches.items()}
    step = mesh_fl.make_fl_round_step(cfg, lr, local_steps=LOCAL_STEPS)
    w = torch.tensor(MESH_WEIGHTS, device=device)
    _sync(device)
    t0 = time.perf_counter()
    agg, _, losses = step(stk, mu, b, w)
    losses = losses.cpu()
    return agg, losses, time.perf_counter() - t0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _mesh_rank(group, rank, n, cfg, batches, device):
    """One client of the int8 ring, on the card, over a gloo group of
    processes: its round (`make_fl_round_step(compressed=True)` over
    `group`), then the pieces timed alone: the client's local training
    (the same round on its slot alone, no barrier), the compressed
    barrier and the plain one over the group. Returns what the parent
    checks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from repro_torch.benchmarks.table1 import LOCAL_STEPS
    from repro_torch.common.bridge import flatten_with_paths, tree_map
    from repro_torch.fl import mesh_fl
    from repro_torch.models import lm

    params = lm.init_params(cfg, 0, device)
    stk = mesh_fl.stack_params_for_clients(params, 1)
    mu = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=device), stk)
    b = {k: torch.from_numpy(v[rank:rank + 1]).to(device)
         for k, v in batches.items()}
    w = torch.tensor(MESH_WEIGHTS, device=device)

    def timed(fn):
        _sync(device)
        dist.barrier(group)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        return out, time.perf_counter() - t0

    step = mesh_fl.make_fl_round_step(cfg, LR, local_steps=LOCAL_STEPS,
                                      compressed=True, group=group, n_pods=n)
    mesh_fl.reset_collective_stats()
    (agg, _, losses), first_s = timed(lambda: step(stk, mu, b, w))
    nbytes = mesh_fl.collective_stats().bytes_by_kind
    _, round_s = timed(lambda: step(stk, mu, b, w))
    # the same client's training alone: a stacked round of its one slot
    # (its barrier of one client is the identity)
    alone = mesh_fl.make_fl_round_step(cfg, LR, local_steps=LOCAL_STEPS)
    (trained, _, _), train_s = timed(
        lambda: alone(stk, mu, b, w[rank:rank + 1]))
    comp_again, comp_s = timed(lambda: mesh_fl.fedavg_sync_compressed(
        trained, params, w, group, n))
    plain, plain_s = timed(lambda: mesh_fl.fedavg_sync(trained, w, group))
    # the int8 bound of tests/test_mesh_fl.py, 2 amax(delta) / 127 with
    # amax over both clients, plus one bf16 rounding of each side
    eps = torch.finfo(cfg.param_torch_dtype).eps
    flat_c, flat_p, flat_t = (dict(flatten_with_paths(t))
                              for t in (agg, plain, trained))
    worst, identical = 0.0, True
    for k, g in flatten_with_paths(params):
        amax = (flat_t[k][0].float() - g.float()).abs().max()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        c, p = flat_c[k][0].float(), flat_p[k][0].float()
        bar = 2 * amax / 127 + eps * p.abs() + 1e-6
        worst = max(worst, ((c - p).abs() / bar).max().item())
        # rank 0's bytes to every rank
        mine = flat_c[k][0].contiguous().view(torch.uint8)
        other = mine.clone()
        dist.broadcast(other, 0, group=group)
        identical &= torch.equal(other, mine)
    same = all(torch.equal(a, b_) for a, b_ in zip(
        (t for _, t in flatten_with_paths(agg)),
        (t for _, t in flatten_with_paths(comp_again))))
    return dict(loss=float(losses[0]), bytes=nbytes, first_s=first_s,
                round_s=round_s, train_s=train_s, comp_s=comp_s, plain_s=plain_s, worst=worst,
                identical=identical, same=same,
                numels=[t.numel() for _, t in flatten_with_paths(params)],
                peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if torch.device(device).type == "cuda" else 0.0))


def _count_local_step(cfg, params, batch, device):
    """One local step of one client (`make_fl_round_step`, C = 1, one
    step) under `WorkCounter`."""
    from repro_torch.common.bridge import tree_map
    from repro_torch.fl import mesh_fl
    from repro_torch.launch.roofline import WorkCounter
    stk = mesh_fl.stack_params_for_clients(params, 1)
    mu = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=device), stk)
    step = mesh_fl.make_fl_round_step(cfg, LR, local_steps=1)
    with WorkCounter() as wc:
        step(stk, mu, batch, torch.ones(1, device=device))
    return wc


def phase_mesh_fl(dev="cuda"):
    """FL in the mesh at phi3-mini-3.8b's main path on the card: a plain
    round of stacked clients, the int8 ring over two gloo ranks on the one
    card, the dry run's count of a local step against the card's, and
    phi3 SMOKE's round against the CPU. The FULL train_4k cell's dry-run
    record, at the card's measured peaks, goes to the port's dry-run path
    (`build/dryrun_torch.json`). Returns the plain round's launches and
    that record."""
    import tempfile
    import numpy as np
    from repro_torch import configs
    from repro_torch.benchmarks.roofline_report import RESULTS
    from repro_torch.benchmarks.table1 import LOCAL_STEPS, main_path
    from repro_torch.common.bridge import flatten_with_paths
    from repro_torch.fl import mesh_fl, mesh_ranks
    from repro_torch.fl.training import TorchTrainerHooks, _measure_peaks
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    gpu = _gpu_name()
    cfg, batch, seq = main_path(MESH_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batches = _mesh_batches(cfg, batch, seq)
    # the hooks draw the same start (seed 0) and the same streams
    hooks = TorchTrainerHooks(CLIENTS, cfg=cfg, local_steps=LOCAL_STEPS,
                              batch=batch, seq=seq, lr=LR, seed=0,
                              device=dev)
    hb = hooks._next_batches()
    _check(all(np.array_equal(hb[c][s][k].cpu().numpy(),
                              batches[k][c, s])
               for c in range(MESH_C) for s in range(LOCAL_STEPS)
               for k in batches), "mesh FL batches differ from the hooks'")
    params = hooks.params
    init = {k: v.clone() for k, v in flatten_with_paths(params)}

    # the plain round, the main path of this phase
    counters = _reset_counters()
    agg, losses, round_s = _stacked_round(cfg, params, batches, LR, dev)
    launches = _launches(counters)
    want = {name: 0 for name in counters}
    want["flash_attention_fwd"] = (MESH_C * LOCAL_STEPS * (1 + cfg.remat)
                                   * _layer_launches(cfg, "attn"))
    _check(launches == want, f"mesh FL round launched {launches}, want {want}")
    flat = dict(flatten_with_paths(agg))
    _check(all(torch.equal(v[0], v[c]) for v in flat.values()
               for c in range(1, MESH_C)),
           "mesh FL: client slots differ after the barrier")
    moved = sum(not torch.equal(flat[k][0], init[k]) for k in init)
    _check(moved == len(init) and bool(torch.isfinite(losses).all()),
           f"mesh FL: {moved} of {len(init)} leaves moved, losses {losses}")
    hook_losses = [float(hooks._local_train(params, hooks.mu[c], hb[c])[2]
                         .mean()) for c in range(MESH_C)]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses.tolist(),
                                                   hook_losses))
    _check(gap <= MESH_LOSS_TOL, f"mesh FL losses {losses.tolist()} vs the "
           f"hooks' {hook_losses}: {gap:.3e} of the loss")
    rounds = [_stacked_round(cfg, params, batches, LR, dev)[2]
              for _ in range(3)]
    stacked_new = mesh_fl.stack_params_for_clients(params, MESH_C)
    w = torch.tensor(MESH_WEIGHTS, device=dev)
    agg_ms = _time_ms(lambda: mesh_fl.fedavg_sync(stacked_new, w), iters=5)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[mesh] {cfg.name} ({cfg.num_layers} layers, {MESH_C} stacked "
          f"clients x {LOCAL_STEPS} steps, batch {batch} x {seq}, weights "
          f"{list(MESH_WEIGHTS)}, lr {LR:g}): losses {losses.tolist()}, the "
          f"hooks' {hook_losses} ({gap:.3e} of the loss, bar "
          f"{MESH_LOSS_TOL:g}); slots identical; launches {launches}; round "
          f"{1e3 * sorted(rounds)[1]:.1f} ms (median of 3, host clock; first "
          f"{1e3 * round_s:.1f}), plain barrier {agg_ms:.3f} ms (CUDA "
          f"events); peak {peak:.2f} GB; {gpu}")
    del hooks, agg, flat, stacked_new
    gc.collect()
    # the ranks' processes allocate on the same card: hand back what this
    # process's allocator keeps cached from the earlier phases
    torch.cuda.empty_cache()

    # the int8 ring over two gloo ranks on the one card
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = mesh_ranks.spawn_ranks(_mesh_rank, MESH_C,
                                       os.path.join(d, "store"), cfg,
                                       batches, dev, timeout=300)
        spawn_s = time.perf_counter() - t0
    ring = (MESH_C - 1) * sum(n + 8 for n in ranks[0]["numels"])
    for r, out in enumerate(ranks):
        _check(out["bytes"] == {"all-reduce": 0, "all-gather": ring},
               f"rank {r} received {out['bytes']}, want {ring} B")
        _check(out["identical"] and out["worst"] <= 1.0,
               f"rank {r}: ranks identical {out['identical']}, worst "
               f"{out['worst']:.3f} of the int8 bound")
        gap = abs(out["loss"] - losses[r].item()) / abs(losses[r].item())
        _check(gap <= MESH_LOSS_TOL, f"rank {r} loss {out['loss']} vs the "
               f"stacked round's {losses[r].item()}")
    print(f"[mesh] {cfg.name} int8 ring over {MESH_C} gloo ranks on the one "
          f"card: ranks bit-identical; within {max(o['worst'] for o in ranks):.3f}"
          f" of the int8 bound (2 amax(delta)/127 + one bf16 rounding); "
          f"received {ring} B a rank ((n-1)(numel + 8) over "
          f"{len(ranks[0]['numels'])} leaves); round "
          + ", ".join(f"{1e3 * o['round_s']:.1f}" for o in ranks)
          + " ms (first: "
          + ", ".join(f"{1e3 * o['first_s']:.1f}" for o in ranks)
          + " ms), its local training alone "
          + ", ".join(f"{1e3 * o['train_s']:.1f}" for o in ranks)
          + " ms, compressed barrier "
          + ", ".join(f"{1e3 * o['comp_s']:.1f}" for o in ranks)
          + " ms, plain barrier over gloo "
          + ", ".join(f"{1e3 * o['plain_s']:.1f}" for o in ranks)
          + " ms (host clock, by rank); peak "
          + ", ".join(f"{o['peak_gb']:.2f}" for o in ranks)
          + f" GB; the round's barrier equals the barrier alone on the same "
          f"client, bit for bit: {[o['same'] for o in ranks]}; spawn to "
          f"results {spawn_s:.1f} s; {gpu}")

    # the dry run against the card: one local step counted on both
    b1 = {k: torch.from_numpy(v[:1, :1]) for k, v in batches.items()}
    meta = _count_local_step(cfg, lm.abstract_params(cfg),
                             {k: v.to("meta") for k, v in b1.items()},
                             "meta")
    card = _count_local_step(cfg, params, {k: v.to(dev) for k, v in b1.items()},
                             dev)
    _check(meta.flops == card.flops and meta.kernels == card.kernels,
           f"meta vs card: FLOPs {meta.flops} vs {card.flops}, kernels "
           f"{meta.kernels} vs {card.kernels}")
    rel = abs(meta.bytes_accessed - card.bytes_accessed) / card.bytes_accessed
    differ = {op: (meta.bytes_by_op.get(op, 0), card.bytes_by_op.get(op, 0))
              for op in set(meta.bytes_by_op) | set(card.bytes_by_op)
              if meta.bytes_by_op.get(op, 0) != card.bytes_by_op.get(op, 0)}
    _check(rel <= MESH_BYTES_TOL, f"meta vs card bytes {meta.bytes_accessed} "
           f"vs {card.bytes_accessed} ({rel:.3e}); ops that differ {differ}")
    print(f"[mesh] one local step, meta vs card: FLOPs {card.flops:.6e} "
          f"equal, kernels {card.kernels} equal; bytes {meta.bytes_accessed:.6e}"
          f" vs {card.bytes_accessed:.6e} ({rel:.3e}, bar {MESH_BYTES_TOL:g});"
          f" aten ops that differ (meta, card bytes): {differ}")
    peak_flops, hbm_bw = _measure_peaks(dev)
    rec = dryrun.run_cell(MESH_ARCH, "train_4k",
                          M.make_production_mesh(multi_pod=False), "single",
                          peak_flops=peak_flops, hbm_bw=hbm_bw, verbose=False)
    rl = rec["roofline"]
    dryrun.write_records(os.path.join(RESULTS, "dryrun_torch.json"), [rec])
    print(f"[mesh] dry run of the FULL {MESH_ARCH} train_4k cell on meta "
          f"({rec['compile_s']} s): {rl['flops']:.4e} FLOP, "
          f"{rl['bytes_accessed']:.4e} B, compute {rl['compute_s']:.3f} s, "
          f"memory {rl['memory_s']:.3f} s, dominant {rl['dominant']}, useful "
          f"{rl['useful_ratio']:.3f}, args a device of 256 "
          f"{rec['memory']['argument_size_in_bytes']:.4e} B; against the "
          f"measured peaks {peak_flops:.4e} FLOP/s, {hbm_bw:.4e} B/s; {gpu}")
    del params, card
    gc.collect()

    # phi3 SMOKE's round on the card against the CPU
    smoke = configs.get_config(MESH_ARCH, smoke=True)
    sb = _mesh_batches(smoke, 2, 64)
    runs = {}
    for device in (dev, "cpu"):
        p0 = lm.init_params(smoke, 0, device)
        agg, lss, _ = _stacked_round(smoke, p0, sb, MESH_SMOKE_LR, device)
        runs[device] = ({k: v[0].cpu() for k, v in flatten_with_paths(agg)},
                        lss)
    start = {k: v.cpu() for k, v in flatten_with_paths(
        lm.init_params(smoke, 0, "cpu"))}
    (gp, gl), (cp, cl) = runs[dev], runs["cpu"]
    worst = 0.0
    for k, c in cp.items():
        update = (c - start[k]).abs().max().item()
        bar = (2e-2 * update
               + 2 * torch.finfo(c.dtype).eps * c.abs().max().item())
        err = (gp[k] - c).abs().max().item()
        _check(err <= bar, f"{smoke.name} mesh FL round card vs CPU: {k} off "
               f"by {err:.3e}, bar {bar:.3e}")
        worst = max(worst, err / bar)
    _check((gl - cl).abs().max().item() <= 2e-4,
           f"{smoke.name} mesh FL losses card {gl} vs CPU {cl}")
    print(f"[mesh] {smoke.name} round (fp32, lr {MESH_SMOKE_LR:g}) card vs "
          f"CPU: losses {gl.tolist()} vs {cl.tolist()}; params within "
          f"{worst:.3f} of the bar (2% of each leaf's update + 2 ulps); phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, rec


PAPER_RUNS = (("mnist", "row"), ("cifar10", "round"), ("aireadi", "round"),
              ("isic2019", "epoch"))
PAPER_ACC = 0.8     # the reference's `tests/test_fl.py::test_fl_learns` bar
# How a model's local training on the card is held to the CPU's: its
# forward and backward precision, and whether over one step only (else
# the smallest client's whole epoch). small_cnn's fp32 epoch is well
# conditioned. The deeper models' fp32 runs part ways from any other
# correct run within an epoch: a ReLU whose input lies within rounding
# of 0 passes or stops its gradient at random, and adamw turns a small
# gradient's noise into a full step. In float64 the card's epoch still
# parts from the CPU's, seeded in adamw's fp32 path. So they are held
# over one step, in float64: the gradients, and the parameters after
# adamw's step. `tools/cnn_fp32_spread.py` measures each of these.
PAPER_PARITY = {"small_cnn": (torch.float32, False),
                "resnet18": (torch.float64, True),
                "resnet50": (torch.float64, True),
                "efficientnet": (torch.float64, True)}


def _paper_client(fed, i, device, dtype=torch.float32, batches=None):
    """Client `i` of `fed` on `device`, its batches in `dtype`, the first
    `batches` of each epoch only (all when None)."""
    import itertools
    from repro_torch.data.synthetic import minibatches
    from repro_torch.fl.client import FLClient
    from repro_torch.optim.optimizers import adamw

    idx = fed.parts[i]
    np_dtype = {torch.float32: "float32", torch.float64: "float64"}[dtype]

    def data_fn(r):
        for x, y in itertools.islice(
                minibatches(fed.ds, idx, 32, seed=100 * r + i), batches):
            yield x.astype(np_dtype), y
    return FLClient(f"client_{i}", fed.apply_fn, adamw(lr=1e-3), data_fn,
                    len(idx), device=device)


def _paper_stub(fed):
    """`ServerTrainerHooks` on the CPU over clients that train nothing:
    the dollars and the trace depend only on the profiles."""
    from repro_torch.common.bridge import tree_map
    from repro_torch.fl.server import FederatedServer, ServerTrainerHooks
    params = tree_map(lambda t: t.cpu(), fed.params0)
    return ServerTrainerHooks(
        FederatedServer(params),
        {f"client_{i}": _paper_client(fed, i, "cpu", batches=0)
         for i in range(len(fed.parts))}, device="cpu")


def _check_paper_dollars(fed, policy, res, trace, n_epochs):
    from repro_torch.examples.paper_reproduction import run_policy
    want, want_trace = run_policy(fed, policy, _paper_stub(fed), n_epochs,
                                  record=True)
    _check(abs(res.total_cost - want.total_cost) <= 1e-9,
           f"{fed.dataset} {policy}: card run ${res.total_cost!r}, CPU stub "
           f"${want.total_cost!r}")
    _check(trace == want_trace, f"{fed.dataset} {policy}: the card run's "
           f"event trace differs from the CPU stub's")
    _check(res.rounds_completed == n_epochs,
           f"{fed.dataset} {policy}: {res.rounds_completed} rounds")
    return len(trace.encode())


def _paper_grads(fed, i, device, dtype):
    """The clients' cross-entropy gradient on client `i`'s first batch
    from the initial weights, by leaf, on the CPU."""
    from repro_torch.common.bridge import (flatten_with_paths, leaves,
                                           tree_map, unflatten_as)
    from repro_torch.data.synthetic import minibatches
    x, y = next(minibatches(fed.ds, fed.parts[i], 32, seed=i))
    params = tree_map(lambda t: t.to(device, dtype), fed.params0)
    live = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
    logits = fed.apply_fn(unflatten_as(params, live),
                          torch.from_numpy(x).to(device, dtype))
    logp = torch.log_softmax(logits, -1)
    y = torch.from_numpy(y).to(device, torch.int64)
    loss = -torch.mean(torch.gather(logp, 1, y[:, None]))
    grads = torch.autograd.grad(loss, live)
    return {k: g.cpu() for (k, _), g in zip(flatten_with_paths(params),
                                            grads)}


def _grad_ratios(got, want):
    """Each leaf's max |got - want| over its bar: 1e-4 of the leaf's
    largest entry in `want`, at least 1e-9 of the model's largest
    (EfficientNet's `bn_pw` biases feed a 1x1 conv and a batch norm,
    which removes a shift: their gradient is rounding only)."""
    top = max(w.abs().max().item() for w in want.values())
    return {k: (got[k] - w).abs().max().item()
            / (1e-4 * max(w.abs().max().item(), 1e-9 * top))
            for k, w in want.items()}


def _update_ratios(got, want, init):
    """Each leaf's max |got - want| over the multi-step bar: 2% of the
    leaf's largest update in `want` (at least a millionth of the model's
    largest) plus 2 fp32 ulps of its largest entry (the parameters are
    fp32 values: adamw rounds each step to fp32); and the leaves `want`
    moves by more than that ulp but `got` leaves where they were."""
    updates = {k: (w - init[k]).abs().max().item() for k, w in want.items()}
    floor = 1e-6 * max(updates.values())
    ratios, stuck = {}, []
    for k, w in want.items():
        ulp = torch.finfo(torch.float32).eps * w.abs().max().item()
        ratios[k] = (got[k] - w).abs().max().item() / (
            2e-2 * max(updates[k], floor) + 2 * ulp)
        if updates[k] > ulp and torch.equal(got[k], init[k]):
            stuck.append(k)
    return ratios, stuck


def _worst(ratios):
    leaf = max(ratios, key=ratios.get)
    return ratios[leaf], leaf


def _paper_train(fed, i, device, dtype, batches):
    """Client `i`'s local epoch (its first `batches` batches when not
    None) from the initial weights: the final parameters by leaf on the
    CPU in float64, the mean loss, the host seconds and the batches."""
    from repro_torch.common.bridge import flatten_with_paths, tree_map
    init = tree_map(lambda t: t.to(device, dtype), fed.params0)
    t0 = time.perf_counter()
    params, m = _paper_client(fed, i, device, dtype, batches) \
        .train_epoch(init, 0)
    return ({k: v.cpu().double() for k, v in flatten_with_paths(params)},
            m.loss, time.perf_counter() - t0, m.n_batches)


def _paper_init(fed):
    from repro_torch.common.bridge import flatten_with_paths
    return {k: v.cpu().double() for k, v in flatten_with_paths(fed.params0)}


def _paper_parity(fed, model):
    """Client training on the card against the CPU from the initial
    weights, on the smallest client, as `PAPER_PARITY` says: every
    parameter within the multi-step bar (`_update_ratios`) and the same
    loss to 1e-5; over one step the gradients too (`_grad_ratios`)."""
    dtype, one_step = PAPER_PARITY[model]
    batches = 1 if one_step else None
    i = min(range(len(fed.parts)), key=lambda j: len(fed.parts[j]))
    what = "first step" if one_step else "local epoch"
    if one_step:
        worst, leaf = _worst(_grad_ratios(
            _paper_grads(fed, i, "cuda", dtype),
            _paper_grads(fed, i, "cpu", dtype)))
        _check(worst <= 1, f"{model} gradient card vs CPU ({dtype}): {leaf} "
               f"at {worst:.3e} of the bar")
        print(f"[paper] {model} client_{i} gradients of the first batch, "
              f"card vs CPU in {dtype}: within {worst:.3e} of the bar "
              f"({leaf}; 1e-4 of the leaf's largest entry)")
    gpu, gpu_loss, _, nb = _paper_train(fed, i, "cuda", dtype, batches)
    cpu, cpu_loss, cpu_s, _ = _paper_train(fed, i, "cpu", dtype, batches)
    ratios, stuck = _update_ratios(gpu, cpu, _paper_init(fed))
    worst, leaf = _worst(ratios)
    _check(not stuck, f"{model}: {stuck} did not move on the card")
    _check(worst <= 1, f"{model} {what} card vs CPU ({dtype}): {leaf} at "
           f"{worst:.3f} of the bar")
    _check(abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss),
           f"{model}: loss card {gpu_loss!r}, CPU {cpu_loss!r}")
    print(f"[paper] {model} client_{i} {what} ({nb} x 32 images) card vs "
          f"CPU in {dtype}: loss {gpu_loss:.6f} vs {cpu_loss:.6f}; params "
          f"within {worst:.4f} of the bar ({leaf}); CPU {cpu_s:.2f} s")


# batches of the largest client's epoch run under `torch.profiler`: one
# checkpoint's worth (tracing a whole epoch's ops costs more than the
# epoch)
PAPER_PROFILED = 5


def _paper_epoch_times(fed, model, gpu_name):
    """Host and device time, images/s and peak memory of the largest
    client's local epoch (a sync round's critical path) as the path runs
    it: fp32, a checkpoint every 5 batches; the median of 3 after a
    warm-up. Then its first `PAPER_PROFILED` batches under
    `torch.profiler`: the device's busy share of them, and the ops that
    kept it busy longest."""
    import itertools
    import statistics
    from torch.profiler import ProfilerActivity, profile
    i = max(range(len(fed.parts)), key=lambda j: len(fed.parts[j]))
    client = fed.clients()[f"client_{i}"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    host, dev = [], []
    for rep in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        _, m = client.train_epoch(fed.params0, rep)
        end.record()
        torch.cuda.synchronize()
        if rep:
            host.append(time.perf_counter() - t0)
            dev.append(start.elapsed_time(end) / 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    epoch_data = client.data_fn
    client.data_fn = lambda r: itertools.islice(epoch_data(r),
                                                PAPER_PROFILED)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.train_epoch(fed.params0, 4)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    client.data_fn = epoch_data
    # the device's own events (kernels, copies, sets)
    ops = _device_ops(prof)
    busy = sum(t for _, t in ops)
    top = sorted(ops, key=lambda kv: -kv[1])[:5]
    h, d = statistics.median(host), statistics.median(dev)
    n = client.n_samples // 32 * 32
    print(f"[paper] {model} {fed.dataset} local epoch of {client.name} "
          f"({m.n_batches} batches of 32, {n} images): host {h:.4f} s "
          f"(median of {host}), {n / h:.1f} images/s; device (CUDA events "
          f"around the epoch) {d:.4f} s (median of {dev}); peak device "
          f"memory {peak:.3f} GB above the {base / 1e9:.3f} GB held before "
          f"it; {gpu_name}")
    print(f"[paper] {model} profiled first {PAPER_PROFILED} batches of "
          f"that epoch (one checkpoint): {window:.4f} s on the host clock "
          f"under the profiler, device busy {busy:.4f} s "
          f"({100 * busy / window:.1f}%); longest on the device: "
          + ", ".join(f"{k[:60]} {t:.4f} s" for k, t in top))


def phase_paper_path():
    """The paper's CNN path on the card: (a) the MNIST row of Table I in
    full, as `repro_torch.examples.paper_reproduction` runs it; (b) one
    FedCostAware round of resnet18 (CIFAR-10) and of resnet50
    (AI-READI); (c) a local epoch of efficientnet (Fed-ISIC2019). Every
    run's dollars and trace equal the CPU stub's, the MNIST models reach
    the reference's accuracy bar, each model's client training on the
    card equals the CPU's (`PAPER_PARITY`), and each model's local epoch
    is timed."""
    from repro_torch.common.bridge import leaves
    from repro_torch.data.synthetic import DATASET_SPECS
    from repro_torch.examples import paper_reproduction as PR

    gpu_name = _gpu_name()
    t_phase = time.perf_counter()
    counters = _reset_counters()
    for dataset, what in PAPER_RUNS:
        model = PR.MODELS[dataset]
        t0 = time.perf_counter()
        if what == "row":
            fed, rows = PR.run("cuda", record=True)
            for row in rows:
                nbytes = _check_paper_dollars(fed, row["policy"],
                                              row["result"], row["trace"],
                                              PR.N_EPOCHS)
                losses = [r["mean_client_loss"]
                          for r in row["server"].history]
                _check(row["acc"] >= PAPER_ACC and all(
                    math.isfinite(x) for x in losses),
                       f"mnist {row['policy']}: accuracy {row['acc']}, "
                       f"losses {losses}")
                print(f"[paper] mnist {row['policy']}: total "
                      f"${row['result'].total_cost!r} (paper "
                      f"${PR.PAPER[row['policy']]}), equal to the CPU stub's "
                      f"(to 1e-9), trace of {nbytes} bytes equal byte for "
                      f"byte; accuracy on the first 512 images "
                      f"{row['acc']:.4f} (bar {PAPER_ACC}); mean client "
                      f"loss by round {[round(x, 4) for x in losses]}")
        else:
            fed = PR.Federation(dataset, 1500, "cuda")
            if what == "round":
                hooks = fed.hooks()
                res, trace = PR.run_policy(fed, "fedcostaware", hooks,
                                           n_epochs=1, record=True)
                nbytes = _check_paper_dollars(fed, "fedcostaware", res,
                                              trace, 1)
                loss = hooks.server.history[-1]["mean_client_loss"]
                _check(math.isfinite(loss), f"{model}: round loss {loss}")
                print(f"[paper] {model} {dataset} one FedCostAware round: "
                      f"total ${res.total_cost!r}, equal to the CPU stub's "
                      f"(to 1e-9), trace of {nbytes} bytes equal; mean "
                      f"client loss {loss:.6f}")
        img, ch, nc = DATASET_SPECS[dataset]
        n_params = sum(t.numel() for t in leaves(fed.params0))
        print(f"[paper] {model} at {dataset}'s ({img}, {ch}, {nc}): "
              f"{n_params} parameters; client sizes "
              f"{[len(p) for p in fed.parts]}; "
              + ("set-up" if what == "epoch" else f"set-up and {what}")
              + f" {time.perf_counter() - t0:.2f} s")
        t1 = time.perf_counter()
        _paper_parity(fed, model)
        t2 = time.perf_counter()
        _paper_epoch_times(fed, model, gpu_name)
        print(f"[paper] {model}: parity {t2 - t1:.2f} s, timed and profiled "
              f"epochs {time.perf_counter() - t2:.2f} s")
        del fed
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    _check(not any(launches.values()),
           f"the paper's path launched the LM kernels: {launches}")
    print(f"[paper] launches of the port's kernels during the paper's path: "
          f"{launches} (the CNN path runs cuDNN and cuBLAS only); phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def _total_launches(path_launches):
    return {name: sum(c[name] for c in path_launches.values())
            for name in _counters()}


def _flash_row(fa, gen, name, B, S, N, H, window, launches, err):
    """Flash at one main path's shape: the kernel, its plain version, its
    bound and SDPA (the window as a boolean mask where there is one)."""
    from repro_torch.launch import roofline as R
    q, k, v = (_randn(gen, B, S, N, H, dtype=torch.bfloat16)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window is None:
        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
    else:
        pos = torch.arange(S, device="cuda")
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))

        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)
    bound, by = _bound_ms(*R.attention_work(B, S, S, N, H, q.element_size(),
                                            window=window), torch.bfloat16)
    return dict(
        name=name, route="cuda", source=FLASH_SM90,
        replaces="src/repro/kernels/flash_attention/kernel.py:85",
        launches=launches, max_abs_err=err,
        ms=_time_ms(lambda: fa.flash_attention_fwd(q, k, v, window=window)),
        plain_ms=_time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                           window=window),
                          iters=3),
        bound_ms=bound, bound_by=by, library_ms=_time_ms(lib))


def _time_flash_fp32_h8(fa, gen):
    """The fp32 kernel's head-dim-8 instance at the SMOKE reference's
    shape (batch 2, seq 64, 8 heads), printed beside its plain version,
    its bound and fp32 SDPA; it runs on no main path."""
    from repro_torch.launch import roofline as R
    B, S, N, H = 2, 64, 8, 8
    q, k, v = (_randn(gen, B, S, N, H) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bound, by = _bound_ms(*R.attention_work(B, S, S, N, H, 4), torch.float32)
    ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v))
    plain = _time_ms(lambda: fa.flash_attention_plain(q, k, v))
    lib = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    print(f"[times] flash_attention_fwd fp32 head dim 8 {(B, S, N, H)} "
          f"(SMOKE; no main path): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bound:.6f} ms ({by}), fp32 SDPA {lib:.4f} ms")


def phase_times(gen, path_launches, mesh_launches, forecast_launches, errs,
                deltas):
    """The kernels line: each kernel at its main path's shape. Launches
    are those of the paths that run it at that shape (phi3's flash: its
    main path, its mesh FL round, `mesh_launches`, and its learned-forecast
    row, `forecast_launches`), or of all of them."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_quant import ops as gq
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.ssd import ops as sd
    from repro_torch.launch import roofline as R

    launches = _total_launches({**path_launches, "mesh FL": mesh_launches,
                                "learned forecast": forecast_launches})
    rows = [_flash_row(fa, gen, "flash_attention_fwd", MAIN_B, MAIN_S,
                       MAIN_N, MAIN_H, None,
                       path_launches["phi3-mini-3.8b"]["flash_attention_fwd"]
                       + mesh_launches["flash_attention_fwd"]
                       + forecast_launches["flash_attention_fwd"],
                       errs["flash_attention_fwd"]),
            _flash_row(fa, gen, FLASH_RG_ROW, *FLASH_RG,
                       path_launches["recurrentgemma-2b"]
                       ["flash_attention_fwd"], errs[FLASH_RG_ROW]),
            _flash_row(fa, gen, FLASH_GRANITE_ROW, *FLASH_GRANITE, None,
                       path_launches["granite-moe-3b-a800m"]
                       ["flash_attention_fwd"], errs[FLASH_GRANITE_ROW])]
    _time_flash_fp32_h8(fa, gen)

    # the codec over one phi3 client's whole delta: every leaf once, as a
    # round of the int8 arm does per participant
    leaves = list(deltas.values())
    _check(all(bool(torch.isfinite(d).all()) for d in leaves),
           "non-finite delta")
    coded = [gq.quantize(d) for d in leaves]
    errs["quantize"] = float(max(
        max((a[0].int() - b[0].int()).abs().max().item(),
            (a[1] - b[1]).abs().max().item())
        for a, b in zip(coded, (gq.quantize_plain(d) for d in leaves))))
    errs["dequantize"] = max(
        (gq.dequantize(qq, s, d.shape)
         - gq.dequantize_plain(qq, s, d.shape)).abs().max().item()
        for (qq, s), d in zip(coded, leaves))
    _check(errs["quantize"] == 0 and errs["dequantize"] == 0,
           f"codec on the main path's delta: kernel and plain differ "
           f"by {errs['quantize']}, {errs['dequantize']} (must be equal)")
    print(f"[kernels] codec on phi3's main-path delta ({len(leaves)} leaves, "
          f"{sum(d.numel() for d in leaves)} elements): bit-equal")
    n = sum(d.numel() for d in leaves)
    nb = sum(qq.shape[0] for qq, _ in coded)
    q_bound, q_by = _bound_ms(*R.codec_work(n, nb, gq.BLOCK), torch.float32)
    d_bound, d_by = _bound_ms(*R.codec_work(n, nb, gq.BLOCK, dequantize=True),
                              torch.float32)
    for name, line, fn, plain_fn, lib_fn, bound, by in [
            ("quantize", 35,
             lambda: [gq.quantize(d) for d in leaves],
             lambda: [gq.quantize_plain(d) for d in leaves],
             None, q_bound, q_by),
            ("dequantize", 54,
             lambda: [gq.dequantize(qq, s, d.shape)
                      for (qq, s), d in zip(coded, leaves)],
             lambda: [gq.dequantize_plain(qq, s, d.shape)
                      for (qq, s), d in zip(coded, leaves)],
             lambda: [torch.mul(qq, s) for qq, s in coded], d_bound, d_by)]:
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/grad_quant/csrc/grad_quant.cu",
            replaces=f"src/repro/kernels/grad_quant/kernel.py:{line}",
            launches=launches[name], max_abs_err=errs[name],
            ms=_time_ms(fn, iters=5), plain_ms=_time_ms(plain_fn, iters=5),
            bound_ms=bound, bound_by=by,
            library_ms=_time_ms(lib_fn, iters=5) if lib_fn else None))

    # ssd at mamba2-1.3b's layer, at the tensor-core kernel's pieces
    b, s, h, p, g, n, chunk = SSD_MAIN
    x, la, Bm, Cm = _ssd_inputs(gen, b, s, h, p, g, n, torch.bfloat16)
    bound, by = _bound_ms(
        *R.ssd_work(b, s, h, p, g, n, min(chunk, sd.SM90_PIECE),
                    x.element_size()), torch.bfloat16)
    rows.append(dict(
        name="ssd_fwd", route="cuda", source=SSD_SM90,
        replaces="src/repro/kernels/ssd/kernel.py:70",
        launches=launches["ssd_fwd"], max_abs_err=errs["ssd_fwd"],
        ms=_time_ms(lambda: sd.ssd_fwd(x, la, Bm, Cm, chunk=chunk)),
        plain_ms=_time_ms(lambda: sd.ssd_plain(x, la, Bm, Cm, chunk=chunk),
                          iters=3),
        bound_ms=bound, bound_by=by, library_ms=None))

    # the RG-LRU scan at recurrentgemma-2b's layer, both modes and the
    # fused backward
    la, u = _rglru_inputs(gen, *RGLRU_MAIN)
    gh = _randn(gen, *RGLRU_MAIN)
    h = rg.rglru_scan_fwd(la, u)
    n = u.numel()
    for name, fn, plain_fn, backward in [
            ("rglru_scan_fwd", lambda: rg.rglru_scan_fwd(la, u),
             lambda: rg.rglru_scan_ref(la, u), False),
            ("rglru_scan_reverse", lambda: rg.rglru_scan_reverse(la, u),
             lambda: rg.rglru_scan_reverse_ref(la, u), False),
            ("rglru_scan_bwd", lambda: rg.rglru_scan_bwd(la, h, gh),
             lambda: rg.rglru_scan_bwd_ref(la, h, gh), True)]:
        bound, by = _bound_ms(*R.rglru_work(n, backward), torch.float32)
        rows.append(dict(
            name=name, route="cuda", source=RGLRU_SRC,
            replaces="src/repro/kernels/rglru/kernel.py:54",
            launches=launches[name], max_abs_err=errs[name],
            ms=_time_ms(fn), plain_ms=_time_ms(plain_fn, iters=3),
            bound_ms=bound, bound_by=by, library_ms=None))

    for r in rows:
        print(f"[times] {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library "
              + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
                 else "none"))
    return rows


def main():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: the port runs on a "
              "CUDA card")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    _check_shapes()
    phase_build()
    errs = phase_kernels(gen)
    path_launches, deltas = {}, None
    for arch, layers, batch, seq, may_stay in paths():
        path_launches[arch], d = phase_main_path(arch, layers, batch, seq,
                                                 may_stay)
        deltas = deltas or d
        del d
    print(f"[main] launches over the four main paths "
          f"({', '.join(path_launches)}): {_total_launches(path_launches)}")
    mesh_launches, dry_rec = phase_mesh_fl()
    t_phase = time.perf_counter()
    for arch in path_launches:
        phase_serve(arch)
    phase_decode_smoke()
    phase_train()
    for arch in STEP_ARCHS:
        phase_train_step_smoke(arch)
    print(f"[times] the decode path and the drivers (phase_serve, "
          f"phase_train, one train step of each SMOKE config): "
          f"{time.perf_counter() - t_phase:.1f} s")
    for arch in REAL_PATHS:
        phase_real(arch)
    forecast_launches, learned_res, learned_log = phase_forecast_report()
    phase_benchmarks(learned_res, learned_log, dry_rec)
    from repro_torch import configs
    for arch in configs.ARCH_IDS:
        if arch != VLM:
            phase_small_reference(arch)
    phase_vlm_reference()
    phase_paper_path()
    rows = phase_times(gen, path_launches, mesh_launches, forecast_launches,
                       errs, deltas)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"[times] chip_smoke.py, build to the kernels line: "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
