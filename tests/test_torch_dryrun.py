"""The port's dry run on the meta device (`repro_torch/launch/dryrun.py`)
on the CPU: each kernel wrapper's meta branch (the plain version's shape
and dtype, one work entry by the kernel's own formula, no launch
counted), the records of a train, a prefill and a decode cell of an
attention, an SSM and an MoE config and of the FL round and the
compressed FL aggregation (the JAX package's keys), the train cells'
useful ratio, and the int8 ring's collective bytes."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jroofline
from repro_torch import configs
from repro_torch.common import bridge
from repro_torch.common.config import SHAPES
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rglru import ops as rg
from repro_torch.kernels.ssd import ops as sd
from repro_torch.launch import dryrun, mesh as M, roofline
from repro_torch.models import lm

PEAKS = dict(peak_flops=989e12, hbm_bw=3.35e12)   # a caller's peaks
# the reference's record keys (`launch/dryrun.py:87-92`) and its
# `memory_analysis` keys that the port has a meaning for
CELL_KEYS = {"arch", "shape", "mesh", "chips", "compile_s", "memory",
             "roofline", "params"}
FL_KEYS = {"arch", "shape", "mesh", "chips", "compile_s", "roofline"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes"}
# the useful ratio (6ND over the counted FLOPs) of the train cells: the
# counts take the forward twice under remat and the backward's products
# twice, plus attention's own products; the MoE's one-hot dispatch and
# combine lower it further. Over all ten configs' train_4k cells it read
# 0.47 (granite-moe) to 0.79 (command-r) on the CPU
USEFUL_TRAIN = (0.45, 0.80)
CELLS = [(arch, shape) for arch in ("phi3-mini-3.8b", "mamba2-1.3b",
                                    "granite-moe-3b-a800m")
         for shape in ("train_4k", "prefill_32k", "decode_32k")]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _counted(fn, counter):
    before = counter.launches
    with roofline.WorkCounter() as wc:
        out = fn()
    assert counter.launches == before, "a meta call counted a launch"
    return out, wc


def _same(meta_out, plain_out):
    assert meta_out.device.type == "meta"
    assert meta_out.shape == plain_out.shape
    assert meta_out.dtype == plain_out.dtype


FLASH_CASES = [((2, 16, 4, 64), torch.bfloat16, None, None),
               ((1, 24, 2, 8), torch.float32, 5, None),
               ((2, 8, 3, 96), torch.float32, None, 30.0)]


@pytest.mark.parametrize("shape,dtype,window,softcap", FLASH_CASES)
def test_flash_meta_branch(shape, dtype, window, softcap):
    B, S, N, H = shape
    x = torch.randn(shape).to(dtype)
    plain = fa.flash_attention_fwd(x, x, x, window=window, softcap=softcap)
    m = _meta(*shape, dtype=dtype)
    out, wc = _counted(lambda: fa.flash_attention_fwd(
        m, m, m, window=window, softcap=softcap), fa.flash_attention_fwd)
    _same(out, plain)
    flops, nbytes = roofline.attention_work(B, S, S, N, H, x.element_size(),
                                            window=window)
    assert wc.kernels == {"flash_attention_fwd": [1, flops, nbytes]}


def test_flash_meta_branch_checks_its_arguments():
    m = _meta(1, 8, 2, 8, dtype=torch.bfloat16)     # bf16 has no head dim 8
    with pytest.raises(ValueError, match="head dim 8"):
        fa.flash_attention_fwd(m, m, m)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention_fwd(m, torch.zeros(1, 8, 2, 8, dtype=m.dtype), m)


@pytest.mark.parametrize("dtype,p,chunk", [(torch.bfloat16, 64, 256),
                                           (torch.float32, 16, 8)])
def test_ssd_meta_branch(dtype, p, chunk):
    b, s, h, g, n = 2, 40, 4, 2, 16
    args = [torch.randn(b, s, h, p).to(dtype), -torch.rand(b, s, h),
            torch.randn(b, s, g, n).to(dtype), torch.randn(b, s, g, n).to(dtype)]
    plain = sd.ssd_fwd(*args, chunk=chunk)
    metas = [_meta(*t.shape, dtype=t.dtype) for t in args]
    out, wc = _counted(lambda: sd.ssd_fwd(*metas, chunk=chunk), sd.ssd_fwd)
    _same(out, plain)
    run_chunk = min(chunk, sd.SM90_PIECE if sd.route(dtype, p) ==
                    sd._STEM_SM90 else s)
    flops, nbytes = roofline.ssd_work(b, s, h, p, g, n, run_chunk,
                                      args[0].element_size())
    assert wc.kernels == {"ssd_fwd": [1, flops, nbytes]}


@pytest.mark.parametrize("mode", ["fwd", "reverse", "bwd"])
def test_rglru_meta_branch(mode):
    B, S, W = 2, 17, 40
    la, u, h = -torch.rand(B, S, W), torch.randn(B, S, W), torch.randn(B, S, W)
    fn = {"fwd": rg.rglru_scan_fwd, "reverse": rg.rglru_scan_reverse,
          "bwd": rg.rglru_scan_bwd}[mode]
    plain = fn(la, u) if mode != "bwd" else fn(la, h, u)
    metas = [_meta(B, S, W) for _ in range(3 if mode == "bwd" else 2)]
    out, wc = _counted(lambda: fn(*metas), fn)
    if mode == "bwd":
        for o, p in zip(out, plain):
            _same(o, p)
    else:
        _same(out, plain)
    flops, nbytes = roofline.rglru_work(B * S * W, backward=mode == "bwd")
    assert wc.kernels == {f"rglru_scan_{mode}": [1, flops, nbytes]}


@pytest.fixture(scope="module")
def records():
    """The cells' records on both production meshes, each cell counted
    once."""
    out = {}
    for arch, shape in CELLS:
        counted = dryrun.count_cell(arch, shape)
        for name, mesh in dryrun._meshes("both"):
            out[arch, shape, name] = dryrun.run_cell(
                arch, shape, mesh, name, counted=counted, verbose=False,
                **PEAKS)
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_records_have_the_reference_keys(records, arch, shape):
    want_rl = {f.name for f in dataclasses.fields(jroofline.Roofline)}
    cfg = configs.get_config(arch)
    single, multi = records[arch, shape, "single"], records[arch, shape,
                                                            "multi"]
    for rec, chips in ((single, 256), (multi, 512)):
        assert set(rec) == CELL_KEYS and set(rec["roofline"]) == want_rl
        assert set(rec["memory"]) == MEMORY_KEYS
        assert rec["chips"] == chips and rec["params"] == lm.param_count(cfg)
        rl = rec["roofline"]
        assert rl["flops"] > 0 and rl["bytes_accessed"] > 0
        assert rl["collective_bytes"] == 0.0
        assert rl["model_flops"] == roofline.model_flops(cfg, SHAPES[shape])
        assert rl["dominant"] in ("compute", "memory")
        json.dumps(rec)
    # the mesh changes the specs, not what one device runs
    assert single["roofline"] == multi["roofline"]
    assert 0 < multi["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mamba2-1.3b",
                                  "granite-moe-3b-a800m"])
def test_train_cells_useful_ratio(records, arch):
    useful = records[arch, "train_4k", "single"]["roofline"]["useful_ratio"]
    assert USEFUL_TRAIN[0] <= useful <= USEFUL_TRAIN[1], useful


def test_argument_bytes_follow_the_specs(records):
    """phi3's train layout (its ZeRO-3 overrides) cuts every weight and
    moment over data x model (256 ways, the pod axis not among them) and
    the batch over every axis: per device, the arguments lie just over
    the whole step's over 256 (the fp32 norm scales and their moments,
    2.4 MB, stay whole on every device). On the multi-pod mesh the
    global batch of 256 does not divide over pod x data x model, so the
    rule drops `model` and cuts it 32 ways."""
    cfg = configs.get_config("phi3-mini-3.8b")
    whole = sum(t.nbytes for t in bridge.leaves(
        dryrun.cell_args(cfg, SHAPES["train_4k"])))
    got = {name: records["phi3-mini-3.8b", "train_4k", name]["memory"][
        "argument_size_in_bytes"] for name in ("single", "multi")}
    assert whole / 256 < got["single"] < 1.02 * whole / 256
    batch = 2 * 256 * 4096 * 4          # int32 tokens and labels
    assert got["multi"] - got["single"] == batch // 32 - batch // 256


def test_fl_round_record():
    rec = dryrun.run_fl_round(M.make_production_mesh(multi_pod=False),
                              "single", local_steps=1, verbose=False, **PEAKS)
    assert set(rec) == FL_KEYS and rec["chips"] == 256
    assert rec["shape"] == "fl_round(ls=1,compressed=False)"
    rl = rec["roofline"]
    assert set(rl) == {f.name for f in dataclasses.fields(jroofline.Roofline)}
    assert rl["collective_bytes"] == 0.0      # one client: no barrier
    assert 0.45 <= rl["useful_ratio"] <= 0.80


@pytest.mark.parametrize("compressed", [False, True])
def test_fl_agg_records_count_the_collective(compressed):
    """Two pods' clients stacked: the int8 ring's bytes a pod receives
    are (n-1) (numel + 8) summed over the leaves, the plain barrier's
    all-reduce payload 4 numel."""
    rec = dryrun.run_fl_agg(M.make_production_mesh(multi_pod=True), "multi",
                            compressed=compressed, link_bw=100e9,
                            verbose=False, **PEAKS)
    assert set(rec) == FL_KEYS and rec["chips"] == 512
    numels = [s for _, s in lm.param_shapes(configs.get_config(
        dryrun.FL_ARCH))]
    n = sum(torch.Size(shape).numel() for shape, _ in numels)
    want = (n + 8 * len(numels)) if compressed else 4 * n
    rl = rec["roofline"]
    assert rl["collective_bytes"] == want
    assert rl["collective_by_kind"] == {
        ("all-gather" if compressed else "all-reduce"): float(want)}
    assert rl["collective_s"] == want / 100e9
    assert rl["model_flops"] == 0.0
