#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
the sources in the checkout, holds each against its plain PyTorch
version on the card, drives the port's main path — FL rounds of
`TorchTrainerHooks` on phi3-mini-3.8b at full width with the depth cut
to 2 layers, 2 rounds of the fp32 arm then 2 of the int8 arm, in the
sync engine's call order — and checks that every kernel of that path
was launched by it. Then it checks a SMOKE-size run on the card against
the same run on the CPU, times each kernel beside its plain version,
its bound and the PyTorch library call that computes the same function
(a yardstick only; the port never calls it), and times one round.

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
ROUNDS_PER_ARM = 2
LOCAL_STEPS = 2


def _fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        _fail(msg)


def _time_ms(fn, iters=10, warmup=2):
    """Mean device milliseconds of `fn` over `iters` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def phase_build():
    from repro_torch.kernels import _build
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    secs = _build.build_all()
    print(f"[build] {len(_build.sources())} kernel sources built in "
          f"{secs:.2f} s")
    for stem in _build.sources():
        for line in _build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {stem}: {line.strip()}")


def phase_kernels(gen):
    """Each kernel against its plain version on the card."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_quant import ops as gq

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    errs = {}
    shape = (MAIN_B, MAIN_S, MAIN_N, MAIN_H)
    q, k, v = (randn(*shape, dtype=torch.bfloat16) for _ in range(3))
    out = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v)
    err = (out.float() - want.float()).abs()
    _check(bool((err <= 2e-2 + 2e-2 * want.float().abs()).all()),
           f"flash bf16 {shape}: max |err| {err.max().item()}")
    errs["flash_attention_fwd"] = err.max().item()
    print(f"[kernels] flash bf16 {shape} causal: max |err| "
          f"{errs['flash_attention_fwd']:.3e} (tolerance 2e-2)")

    for (B, S, N, H, window, softcap) in [
            (2, 256, 2, 64, None, None), (1, 512, 2, 32, 128, None),
            (2, 200, 2, 96, None, 30.0), (1, 300, 1, 256, None, None),
            (2, 77, 4, 16, None, None), (1, 130, 2, 128, 64, 10.0)]:
        q, k, v = (randn(B, S, N, H) for _ in range(3))
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
    for name, x in [("(2, 3072, 8192) leaf", randn(2, 3072, 8192, scale=1e-3)),
                    ("ragged 6149", randn(2 * 3072 + 5, scale=1e-3)),
                    ("half-way ties", tie)]:
        _check_codec(gq, x, name)
    q, _ = gq.quantize(tie)
    _check(q[0, :7].tolist() == [127, 2, 4, -2, -4, 0, 0],
           f"codec ties rounded {q[0, :7].tolist()}")
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


def _play_rounds(hooks, first_round, n_rounds):
    for r in range(first_round, first_round + n_rounds):
        for c in hooks.clients:
            hooks.run_local(c, r)
        hooks.aggregate(list(hooks.clients), r,
                        staleness={c: 0 for c in hooks.clients})


def phase_main_path():
    """The main path at phi3-mini-3.8b's full width, depth cut to 2."""
    from repro_torch import configs
    from repro_torch.common.bridge import flatten_with_paths
    from repro_torch.comms.payload import quantized_leaf_bytes
    from repro_torch.fl.training import TorchTrainerHooks
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_quant import ops as gq

    cfg = dataclasses.replace(configs.get_config("phi3-mini-3.8b"),
                              num_layers=2)

    def make(quantize):
        return TorchTrainerHooks(CLIENTS, cfg=cfg, local_steps=LOCAL_STEPS,
                                 batch=MAIN_B, seq=MAIN_S, quantize=quantize,
                                 seed=0, device="cuda")

    hooks = make(False)
    init = {k: v.clone() for k, v in flatten_with_paths(hooks.params)}
    n_params = sum(v.numel() for v in init.values())
    print(f"[main] {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}x"
          f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"layers={cfg.num_layers} {cfg.param_dtype} remat={cfg.remat}: "
          f"{n_params} parameters; {len(CLIENTS)} clients, "
          f"local_steps={LOCAL_STEPS}, batch={MAIN_B}, seq={MAIN_S}")

    fa.flash_attention_fwd.launches = 0
    gq.quantize.launches = 0
    gq.dequantize.launches = 0
    torch.cuda.reset_peak_memory_stats()
    _play_rounds(hooks, 0, ROUNDS_PER_ARM)
    fp32_losses = [r["mean_loss"] for r in hooks.losses]
    fp32_payload = hooks.update_payload(quantized=False)
    del hooks
    hooks = make(True)
    _play_rounds(hooks, 0, ROUNDS_PER_ARM)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "quantize": gq.quantize.launches,
                "dequantize": gq.dequantize.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    int8_losses = [r["mean_loss"] for r in hooks.losses]
    print(f"[main] fp32 arm mean losses {fp32_losses}; int8 arm mean losses "
          f"{int8_losses}; peak device memory {peak_gb:.2f} GB")
    print(f"[main] launches during the main path: {launches}")

    _check(all(math.isfinite(x) for x in fp32_losses + int8_losses),
           "non-finite loss")
    # every self-attention layer launches flash twice a step (forward and
    # the remat recompute); every leaf of every participant's delta goes
    # through the codec once a round on the int8 arm
    n_rounds = 2 * ROUNDS_PER_ARM
    want_flash = n_rounds * len(CLIENTS) * LOCAL_STEPS * cfg.num_layers * 2
    n_leaves = len(init)
    want_codec = ROUNDS_PER_ARM * len(CLIENTS) * n_leaves
    _check(launches["flash_attention_fwd"] == want_flash,
           f"flash launched {launches['flash_attention_fwd']} times, "
           f"want {want_flash}")
    _check(launches["quantize"] == want_codec == launches["dequantize"],
           f"codec launched {launches}, want {want_codec} each")

    final = dict(flatten_with_paths(hooks.params))
    moved = [k for k in init if not torch.equal(final[k], init[k])]
    _check(len(moved) == n_leaves, f"leaves that did not move: "
           f"{sorted(set(init) - set(moved))}")
    q_payload = hooks.update_payload(quantized=True)
    want_bytes = sum(quantized_leaf_bytes(v.numel()) for v in init.values())
    _check(q_payload.num_bytes == want_bytes,
           f"int8 payload {q_payload.num_bytes} B, leaf sum {want_bytes} B")
    _check(q_payload.num_bytes < fp32_payload.num_bytes,
           "int8 payload not below fp32")
    print(f"[main] payload per client update: fp32 {fp32_payload.num_bytes} "
          f"B, int8 {q_payload.num_bytes} B over {q_payload.n_leaves} leaves")
    deltas = {k: final[k].float() - init[k].float() for k in init}
    return hooks, launches, deltas


def phase_small_reference():
    """A SMOKE-size run on the card against the same run on the CPU."""
    from repro_torch.common.bridge import flatten_with_paths
    from repro_torch.fl.training import TorchTrainerHooks

    for quantize in (False, True):
        runs = []
        for device in ("cuda", "cpu"):
            # one round at the default lr: at a much smaller lr a
            # parameter's fp32 ulp is a sizeable share of its update, and
            # over more rounds the rounding differences between two
            # correct runs grow until they part ways
            hooks = TorchTrainerHooks(CLIENTS, smoke=True, local_steps=2,
                                      batch=2, seq=64, quantize=quantize,
                                      device=device)
            init = {k: v.cpu() for k, v in flatten_with_paths(hooks.params)}
            _play_rounds(hooks, 0, 1)
            runs.append(({k: v.cpu() for k, v in
                          flatten_with_paths(hooks.params)},
                         [r["mean_loss"] for r in hooks.losses]))
        (gpu, gpu_loss), (cpu, cpu_loss) = runs
        _check(max(abs(a - b) for a, b in zip(gpu_loss, cpu_loss)) <= 2e-4,
               f"SMOKE losses card {gpu_loss} vs CPU {cpu_loss}")
        worst, leaf = max((((gpu[k] - cpu[k]).abs().max()
                            / (cpu[k] - init[k]).abs().max()).item(), k)
                          for k in cpu)
        _check(worst <= 2e-2, f"SMOKE params card vs CPU: {leaf} within "
               f"{worst:.3e} of its largest update")
        print(f"[reference] SMOKE quantize={quantize}: card vs CPU loss "
              f"{gpu_loss} vs {cpu_loss}; params within {worst:.3e} of the "
              f"largest update ({leaf}; tolerance 2e-2)")


def phase_times(gen, launches, errs, deltas, hooks):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grad_quant import ops as gq

    rows = []
    shape = (MAIN_B, MAIN_S, MAIN_N, MAIN_H)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bound, by = _bound_ms(4 * q.numel() * q.element_size(),
                          _causal_flops(*shape), torch.bfloat16)
    rows.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_fwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:85",
        launches=launches["flash_attention_fwd"],
        max_abs_err=errs["flash_attention_fwd"],
        ms=_time_ms(lambda: fa.flash_attention_fwd(q, k, v)),
        plain_ms=_time_ms(lambda: fa.flash_attention_plain(q, k, v)),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True))))

    # the codec over one client's whole delta: every leaf once, as a
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
    print(f"[kernels] codec on the main path's delta ({len(leaves)} leaves, "
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
    for r in rows:
        print(f"[times] {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library "
              + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
                 else "none"))
    round_s = hooks.measure_round_s(warmup=1, iters=2)
    print(f"[times] measure_round_s (int8 arm, {len(CLIENTS)} clients x "
          f"{LOCAL_STEPS} steps): {round_s:.4f} s")
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
    hooks, launches, deltas = phase_main_path()
    phase_small_reference()
    rows = phase_times(gen, launches, errs, deltas, hooks)

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
