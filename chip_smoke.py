#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
the sources in the checkout, holds each against its plain PyTorch
version on the card, and drives the port's main path — FL rounds of
`TorchTrainerHooks`, 1 round of the fp32 arm then 1 of the int8 arm, in
the sync engine's call order — for each of three models at full width
with the depth cut: phi3-mini-3.8b (2 layers), mamba2-1.3b (2 layers)
and recurrentgemma-2b (3 layers, one (RG-LRU, RG-LRU, local attention)
block). Every kernel's launch counter is set to 0 just before each
model's rounds and read just after, and each count must be what that
model's path launches. Then it checks a SMOKE-size run of each model on
the card against the same run on the CPU, and times each kernel beside
its plain version, its bound and the PyTorch library call that computes
the same function where there is one (a yardstick only; the port never
calls it), and one round of each model. After the build it reads the
SASS of the two tensor-core libraries, bf16 flash attention and the
bf16 SSD scan, and fails unless every head dim's and every state dim's
instance runs its products on the tensor cores (HGMMA) and ptxas
reports no spill in either, nor in the RG-LRU scan's library. mamba2's
ssd launches must all go to the tensor-core kernel, and recurrentgemma's
backward must run the fused RG-LRU backward, never the reverse scan
alone.

Any failure exits non-zero. Without a CUDA device, or outside a
checkout, it exits non-zero before printing any result. The last two
lines of standard output are the card's name and power limit as
`nvidia-smi` reports them, and
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Before them comes one `{"kernels": [...]}` line.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound
# of a kernel is the larger of its bytes over HBM bandwidth and its
# operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

MAIN_B, MAIN_S, MAIN_N, MAIN_H = 4, 1024, 32, 96
CLIENTS = ("client_0", "client_1")
LOCAL_STEPS = 2
LR = 5e-3                           # the hooks' default

# model, depth, batch, sequence of each main path, and the leaves that
# may stay put in its round. mamba2 runs at the context it was trained
# at (8 chunks of 256); recurrentgemma at twice its 2048 window, so the
# window masks. mamba2's D (all ones) and recurrentgemma's bf16 wo and
# wv take steps far below half an ulp of their entries in two steps
PATHS = (("phi3-mini-3.8b", 2, MAIN_B, MAIN_S, ()),
         ("mamba2-1.3b", 2, 2, 2048, ("blocks/00_mamba2/mix/D",)),
         ("recurrentgemma-2b", 3, 1, 4096,
          ("blocks/02_local_attn/mix/wo", "blocks/02_local_attn/mix/wv")))
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
# rows of the pieces that ssd_fwd_sm90.cu cuts the sequence into, whatever
# chunk the caller names
SSD_PIECE = 128


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


def _bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _causal_flops(B, S, N, H, window=None):
    """Multiply-adds of QK^T and PV over the unmasked (query, key) pairs."""
    pairs = sum(min(i + 1, window or i + 1) for i in range(S))
    return 4.0 * H * pairs * B * N


def _ssd_flops(b, s, h, p, n, chunk):
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

    for (B, S, N, H, window, softcap) in [
            (2, 256, 2, 64, None, None), (1, 512, 2, 32, 128, None),
            (2, 200, 2, 96, None, 30.0), (1, 300, 1, 256, None, None),
            (1, 600, 2, 256, 128, None), (2, 77, 4, 16, None, None),
            (1, 130, 2, 128, 64, 10.0)]:
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


def _play_rounds(hooks, first_round, n_rounds):
    for r in range(first_round, first_round + n_rounds):
        for c in hooks.clients:
            hooks.run_local(c, r)
        hooks.aggregate(list(hooks.clients), r,
                        staleness={c: 0 for c in hooks.clients})


def _expected_launches(cfg, n_leaves):
    """What one fp32 round and one int8 round of `cfg` launch: a layer's
    forward kernels once a step, twice in the stacked blocks under remat
    (the forward and the recompute), the RG-LRU fused backward once a
    step in the backward (the reverse scan alone never), and the codec
    on every leaf of every participant's delta on the int8 arm."""
    steps = 2 * len(CLIENTS) * LOCAL_STEPS

    def layers(*kinds, fwd=True):
        per_block = sum(cfg.pattern.count(k) for k in kinds) * cfg.n_super
        tail = sum(cfg.tail_pattern.count(k) for k in kinds)
        return steps * (per_block * (2 if fwd and cfg.remat else 1) + tail)

    return {"flash_attention_fwd": layers("attn", "local_attn"),
            "quantize": len(CLIENTS) * n_leaves,
            "dequantize": len(CLIENTS) * n_leaves,
            "ssd_fwd": layers("mamba2"),
            "rglru_scan_fwd": layers("rglru"),
            "rglru_scan_reverse": 0,
            "rglru_scan_bwd": layers("rglru", fwd=False)}


def phase_main_path(arch, layers, batch, seq, may_stay):
    """One model's main path at full width, depth cut to `layers`."""
    from repro_torch import configs
    from repro_torch.common.bridge import flatten_with_paths
    from repro_torch.comms.payload import quantized_leaf_bytes
    from repro_torch.fl.training import TorchTrainerHooks

    cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers)

    def make(quantize):
        return TorchTrainerHooks(CLIENTS, cfg=cfg, local_steps=LOCAL_STEPS,
                                 batch=batch, seq=seq, lr=LR,
                                 quantize=quantize, seed=0, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    hooks = make(False)
    init = {k: v.clone() for k, v in flatten_with_paths(hooks.params)}
    n_params = sum(v.numel() for v in init.values())
    print(f"[main] {cfg.name} d_model={cfg.d_model} pattern={cfg.pattern} "
          f"layers={cfg.num_layers} vocab={cfg.vocab_size} {cfg.param_dtype} "
          f"remat={cfg.remat}: {n_params} parameters in {len(init)} leaves; "
          f"{len(CLIENTS)} clients, local_steps={LOCAL_STEPS}, "
          f"batch={batch}, seq={seq}")

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    counters["ssd_fwd"].sm90_launches = 0
    _play_rounds(hooks, 0, 1)
    fp32_losses = [r["mean_loss"] for r in hooks.losses]
    fp32_payload = hooks.update_payload(quantized=False)
    del hooks
    hooks = make(True)
    _play_rounds(hooks, 0, 1)
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
    round_s = hooks.measure_round_s(warmup=1, iters=2)
    print(f"[times] {cfg.name} measure_round_s (int8 arm, {len(CLIENTS)} "
          f"clients x {LOCAL_STEPS} steps, batch {batch}, seq {seq}): "
          f"{round_s:.4f} s")
    deltas = {k: final[k].float() - init[k].float() for k in init}
    return launches, deltas


# Card-against-CPU bar of one SMOKE round, per leaf: a share of the
# leaf's update on the CPU plus 2 ulps of its largest entry, and a leaf
# that moved by more than an ulp on the CPU must move on the card. The
# share is 2% but for recurrentgemma SMOKE, which is ill-conditioned in
# fp32 (ROADMAP §3): its zero-initialised biases come out a few percent
# of their update apart between card and CPU, while on the card the
# gradients through its kernels agree with those through their plain
# versions to 1e-4 (tests/test_torch_cuda.py)
SMOKE_SHARE = {"recurrentgemma-2b": 1e-1}


def phase_small_reference(arch):
    """A SMOKE-size run on the card against the same run on the CPU."""
    from repro_torch.common.bridge import flatten_with_paths
    from repro_torch.fl.training import TorchTrainerHooks

    share = SMOKE_SHARE.get(arch, 2e-2)
    for quantize in (False, True):
        runs = []
        for device in ("cuda", "cpu"):
            # one round at the default lr: at a much smaller lr a
            # parameter's fp32 ulp is a sizeable share of its update, and
            # over more rounds the rounding differences between two
            # correct runs grow until they part ways
            hooks = TorchTrainerHooks(CLIENTS, model=arch, smoke=True,
                                      local_steps=2, batch=2, seq=64,
                                      quantize=quantize, device=device)
            init = {k: v.cpu() for k, v in flatten_with_paths(hooks.params)}
            _play_rounds(hooks, 0, 1)
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
        print(f"[reference] {arch} SMOKE quantize={quantize}: card vs CPU "
              f"loss {gpu_loss} vs {cpu_loss}; params within {worst:.3f} of "
              f"the bar ({leaf}; bar {share:g} of the leaf's update + 2 "
              f"ulps)")


def _total_launches(path_launches):
    return {name: sum(c[name] for c in path_launches.values())
            for name in _counters()}


def _flash_row(fa, gen, name, B, S, N, H, window, launches, err):
    """Flash at one main path's shape: the kernel, its plain version, its
    bound and SDPA (the window as a boolean mask where there is one)."""
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
    bound, by = _bound_ms(4 * q.numel() * q.element_size(),
                          _causal_flops(B, S, N, H, window), torch.bfloat16)
    return dict(
        name=name, route="cuda", source=FLASH_SM90,
        replaces="src/repro/kernels/flash_attention/kernel.py:85",
        launches=launches, max_abs_err=err,
        ms=_time_ms(lambda: fa.flash_attention_fwd(q, k, v, window=window)),
        plain_ms=_time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                           window=window),
                          iters=3),
        bound_ms=bound, bound_by=by, library_ms=_time_ms(lib))


def phase_times(gen, path_launches, errs, deltas):
    """The kernels line: each kernel at its main path's shape. Launches
    are those of the path that runs it at that shape, or of all three."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_quant import ops as gq
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.ssd import ops as sd

    launches = _total_launches(path_launches)
    rows = [_flash_row(fa, gen, "flash_attention_fwd", MAIN_B, MAIN_S,
                       MAIN_N, MAIN_H, None,
                       path_launches["phi3-mini-3.8b"]["flash_attention_fwd"],
                       errs["flash_attention_fwd"]),
            _flash_row(fa, gen, FLASH_RG_ROW, *FLASH_RG,
                       path_launches["recurrentgemma-2b"]
                       ["flash_attention_fwd"], errs[FLASH_RG_ROW])]

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
    codec_bytes = 4 * n + nb * gq.BLOCK + 4 * nb
    # per element: abs and max, then a divide, a round and two clamps;
    # dequantize one multiply
    q_bound, q_by = _bound_ms(codec_bytes, 5.0 * n + nb, torch.float32)
    d_bound, d_by = _bound_ms(codec_bytes, 1.0 * n, torch.float32)
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

    # ssd at mamba2-1.3b's layer: x and y, la, one group of B and C once
    b, s, h, p, g, n, chunk = SSD_MAIN
    x, la, Bm, Cm = _ssd_inputs(gen, b, s, h, p, g, n, torch.bfloat16)
    nbytes = (2 * x.numel() * x.element_size() + la.numel() * 4
              + 2 * Bm.numel() * Bm.element_size())
    bound, by = _bound_ms(
        nbytes, _ssd_flops(b, s, h, p, n, min(chunk, SSD_PIECE)),
        torch.bfloat16)
    rows.append(dict(
        name="ssd_fwd", route="cuda", source=SSD_SM90,
        replaces="src/repro/kernels/ssd/kernel.py:70",
        launches=launches["ssd_fwd"], max_abs_err=errs["ssd_fwd"],
        ms=_time_ms(lambda: sd.ssd_fwd(x, la, Bm, Cm, chunk=chunk)),
        plain_ms=_time_ms(lambda: sd.ssd_plain(x, la, Bm, Cm, chunk=chunk),
                          iters=3),
        bound_ms=bound, bound_by=by, library_ms=None))

    # the RG-LRU scan at recurrentgemma-2b's layer, both modes: read la
    # and the input, write the output, one fused multiply-add a step; the
    # fused backward reads la, gh and h and writes dlog_a and db, a fused
    # multiply-add and two multiplies a step
    la, u = _rglru_inputs(gen, *RGLRU_MAIN)
    gh = _randn(gen, *RGLRU_MAIN)
    h = rg.rglru_scan_fwd(la, u)
    n = u.numel()
    for name, fn, plain_fn, arrays, ops in [
            ("rglru_scan_fwd", lambda: rg.rglru_scan_fwd(la, u),
             lambda: rg.rglru_scan_ref(la, u), 3, 2.0),
            ("rglru_scan_reverse", lambda: rg.rglru_scan_reverse(la, u),
             lambda: rg.rglru_scan_reverse_ref(la, u), 3, 2.0),
            ("rglru_scan_bwd", lambda: rg.rglru_scan_bwd(la, h, gh),
             lambda: rg.rglru_scan_bwd_ref(la, h, gh), 5, 4.0)]:
        bound, by = _bound_ms(arrays * n * 4, ops * n, torch.float32)
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
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: the port runs on a "
              "CUDA card")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    phase_build()
    errs = phase_kernels(gen)
    path_launches, deltas = {}, None
    for arch, layers, batch, seq, may_stay in PATHS:
        path_launches[arch], d = phase_main_path(arch, layers, batch, seq,
                                                 may_stay)
        deltas = deltas or d
        del d
    print(f"[main] launches over the three main paths: "
          f"{_total_launches(path_launches)}")
    for arch, *_ in PATHS:
        phase_small_reference(arch)
    rows = phase_times(gen, path_launches, errs, deltas)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
