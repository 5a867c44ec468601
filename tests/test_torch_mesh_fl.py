"""The port's FL in the mesh (`repro_torch/fl/mesh_fl.py`) against the
JAX package's `fl/mesh_fl.py` on the CPU: the plain FedAvg barrier, the
per-tensor int8 quantiser, the int8 ring over 2 gloo ranks (spawned
processes that import no JAX) against the reference on a 2-pod mesh, and
over 3 and 4 ranks against a numpy model of the ring's order, and the
round step, stacked and over ranks, for SMOKE configs.

The reference runs on a `jax.sharding.Mesh` built directly over 2 host
devices, whose axes are `Auto`: under `jax.make_mesh`'s `Explicit` axes
its `with_sharding_constraint` is an assertion, the fault that fails
`tests/test_mesh_fl.py::TestFedAvgSync::test_round_step_sync_barrier`
(ROADMAP §3, fault (a)). The stacked round step is held to the
reference's with `shard=INERT`."""
import os

# 2 host devices so a real (pod=2) mesh exists; must precede jax import.
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.common import compat
from repro.fl import mesh_fl as jmesh_fl
from repro.models import lm as jlm
from repro.sharding import rules as JR
from repro_torch import configs
from repro_torch.common import bridge
from repro_torch.examples import mesh_fl_lm
from repro_torch.fl import mesh_fl, mesh_ranks
from repro_torch.models import lm

pytestmark = pytest.mark.skipif(
    jax.device_count() < 2, reason="needs >=2 devices (XLA_FLAGS set too "
    "late: another test initialized jax first)")

# the multi-step bars of ROADMAP §3: lr 2e-4, losses within 2e-4, every
# leaf within 2% of its update plus 2 ulps of its largest entry (10% for
# recurrentgemma SMOKE, ill-conditioned in fp32)
LR, LOSS_TOL, SHARE = 2e-4, 2e-4, {"recurrentgemma-2b": 1e-1}
MODELS = ["phi3-mini-3.8b", "mamba2-1.3b", "recurrentgemma-2b",
          "granite-moe-3b-a800m"]
C, STEPS, B, S = 2, 2, 2, 16
WEIGHTS = np.array([3.0, 1.0], np.float32)


def _auto_mesh():
    return Mesh(np.array(jax.devices()[:2]).reshape(2, 1, 1),
                ("pod", "data", "model"))


def _np(tree):
    return {k: bridge._to_numpy(v) if isinstance(v, torch.Tensor)
            else np.asarray(v).astype(np.float32)
            if np.asarray(v).dtype == jnp.bfloat16 else np.asarray(v)
            for k, v in bridge.flatten_with_paths(tree)}


def _torch(tree):
    return bridge.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def tiny_tree(seed=0):
    """`tests/test_mesh_fl.py`'s tiny stacked tree."""
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(2, 8, 16) * 0.1).astype(np.float32),
            "b": (rng.randn(2, 16) * 0.1).astype(np.float32)}


def _within_ulp(got, want, n=1):
    """Every entry within n ulps, in the leaf's dtype, of the leaf's
    largest entry (eps max |want|): a weighted sum of entries of
    opposite signs keeps the rounding of its terms."""
    eps = float(torch.finfo(got.dtype).eps)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return np.abs(got - want).max() <= n * eps * np.abs(want).max()


# ---------------------------------------------------------------------------
# The plain barrier and the quantiser.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weights", [[3.0, 1.0], [0.3, 0.7], [1.0, 2.0]])
def test_fedavg_sync_tiny_tree(weights):
    """Bit-equal where the normalised weights are exact ([3, 1] / 4);
    otherwise within 1 ulp of the leaf's largest entry: the reference's
    einsum over the client dim may fuse a multiply into the add, the
    port rounds each product first."""
    stk, w = tiny_tree(), np.asarray(weights, np.float32)
    want = jmesh_fl.fedavg_sync(jax.tree.map(jnp.asarray, stk),
                                jnp.asarray(w))
    got = mesh_fl.fedavg_sync(_torch(stk), torch.from_numpy(w))
    for k in stk:
        assert _within_ulp(got[k], want[k])
        assert torch.equal(got[k][0], got[k][1])
        if weights == [3.0, 1.0]:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_sync_stacked_phi3(dtype):
    """Two phi3 SMOKE clients, fp32 and bf16 leaves: within 1 ulp, in the
    leaf's dtype, of its largest entry of the reference's."""
    cfg = configs.get_config("phi3-mini-3.8b", smoke=True)
    rng = np.random.RandomState(1)
    flat = {k: rng.randn(C, *shape).astype(np.float32) * 0.1
            for k, (shape, _) in lm.param_shapes(cfg)}
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    w = np.array([0.6, 0.45], np.float32)
    want = jmesh_fl.fedavg_sync({k: jnp.asarray(v, jd)
                                 for k, v in flat.items()}, jnp.asarray(w))
    got = mesh_fl.fedavg_sync({k: torch.from_numpy(v).to(td)
                               for k, v in flat.items()}, torch.from_numpy(w))
    for k in flat:
        assert got[k].dtype == td
        assert _within_ulp(got[k], np.asarray(want[k]).astype(np.float32)), k


QUANT_CASES = {
    "normal": np.random.RandomState(0).randn(4096).astype(np.float32),
    "zeros": np.zeros((3, 5), np.float32),
    # x / scale lands on halves: 63.5, 0.5, 2.5 round to even
    "halves": np.array([127.0, 63.5, -0.5, 0.5, 1.5, -63.5, 2.5, -2.5],
                       np.float32),
    "tiny": np.full(7, 1e-30, np.float32),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_int8_is_bit_equal(case):
    x = QUANT_CASES[case]
    jq, js = jmesh_fl._quantize_int8(jnp.asarray(x))
    q, s = mesh_fl._quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    assert np.array_equal(mesh_fl._dequantize_int8(q, s).numpy(),
                          np.asarray(jmesh_fl._dequantize_int8(jq, js)))


# ---------------------------------------------------------------------------
# The int8 ring: 2 gloo ranks against the reference, 3 and 4 against a
# numpy model of the ring's order.
# ---------------------------------------------------------------------------
def ring_model(stk, glob, w):
    """numpy model of the ring: pod r adds its own dequantised weighted
    delta, then those of pods r-1, r-2, ...; each product and sum
    rounded to fp32 in that order."""
    f32 = np.float32
    wn = (w / w.sum()).astype(f32)
    out = {}
    for k, p in stk.items():
        n = p.shape[0]
        deltas = p.astype(f32) - glob[k].astype(f32)[None]
        qs, scales = [], []
        for d in deltas:
            scale = f32(max(np.abs(d).max(), f32(1e-12))) / f32(127.0)
            qs.append(np.clip(np.round(d / scale), -127, 127).astype(np.int8))
            scales.append(scale)
        rows = []
        for r in range(n):
            acc = qs[r].astype(f32) * scales[r] * wn[r]
            for t in range(1, n):
                j = (r - t) % n
                acc = acc + qs[j].astype(f32) * scales[j] * wn[j]
            rows.append(glob[k].astype(f32) + acc)
        out[k] = np.stack(rows).astype(p.dtype)
    return out


def _ring_bytes(leaves, n):
    """What each rank receives: n-1 pieces of int8 values, an fp32 scale
    and an fp32 weight a leaf (`leaves` one client's, unstacked)."""
    return sum((n - 1) * (v.size + 8) for v in leaves)


def _phi3_round_inputs():
    cfg = configs.get_config("phi3-mini-3.8b", smoke=True)
    params = _np(lm.init_params(cfg, seed=0, device="cpu"))
    rng = np.random.RandomState(0)
    batches = {k: rng.randint(0, cfg.vocab_size, (C, STEPS, B, S)
                              ).astype(np.int32) for k in ("tokens", "labels")}
    return cfg, bridge.unflatten(params), batches


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One pair of gloo ranks serves every 2-rank case: the tiny tree's
    compressed and plain aggregates, and phi3 SMOKE's compressed round."""
    stk = tiny_tree(1)
    glob = {k: v[0] * np.float32(0.9) for k, v in stk.items()}
    w = np.array([1.0, 2.0], np.float32)
    cfg, params, batches = _phi3_round_inputs()
    tasks = [(mesh_ranks.aggregate_on_rank, (stk, glob, w, True, "cpu")),
             (mesh_ranks.aggregate_on_rank, (stk, glob, w, False, "cpu")),
             (mesh_ranks.round_on_rank, (cfg, params, batches, WEIGHTS, LR,
                                         STEPS, True, "cpu"))]
    store = str(tmp_path_factory.mktemp("ranks2") / "store")
    out = mesh_ranks.spawn_ranks(mesh_ranks.tasks_on_rank, 2, store, tasks)
    return dict(stk=stk, glob=glob, w=w, params=params, batches=batches,
                out=out)


def test_compressed_two_ranks_match_the_reference(two_ranks):
    """Each rank against the reference's pod of its index, on the 2-pod
    mesh: within 2 ulps of each leaf's largest entry (the reference may
    fuse a product into the ring's add), the two ranks bit-identical
    (a + b = b + a), and within the int8 bound of the plain average
    (`tests/test_mesh_fl.py`'s 2 amax(delta) / 127)."""
    stk, glob, w = two_ranks["stk"], two_ranks["glob"], two_ranks["w"]
    mesh = _auto_mesh()
    with compat.set_mesh(mesh):
        want = jax.jit(lambda s, g, ww: jmesh_fl.fedavg_sync_compressed(
            s, g, ww, mesh, 2))(jax.tree.map(jnp.asarray, stk),
                                 jax.tree.map(jnp.asarray, glob),
                                 jnp.asarray(w))
    plain = jmesh_fl.fedavg_sync(jax.tree.map(jnp.asarray, stk),
                                 jnp.asarray(w))
    (agg0, bytes0), (agg1, bytes1) = [r[0] for r in two_ranks["out"]]
    for k in stk:
        ref = np.asarray(want[k])
        ulp = np.finfo(np.float32).eps * np.abs(ref).max()
        for r, agg in enumerate((agg0, agg1)):
            assert np.abs(agg[k][0] - ref[r]).max() <= 2 * ulp, (k, r)
        assert np.array_equal(agg0[k], agg1[k])
        amax = np.abs(stk[k] - glob[k][None]).max()
        assert np.abs(agg0[k][0] - np.asarray(plain[k][0])).max() <= \
            2 * amax / 127 + 1e-6
    assert bytes0 == bytes1 == {"all-reduce": 0,
                                "all-gather": _ring_bytes(
                                    (v[0] for v in stk.values()), 2)}


def test_plain_two_ranks_match_the_stacked_barrier(two_ranks):
    """`fedavg_sync` over 2 gloo ranks (an fp32 all_reduce) equals the
    stacked one bit for bit, and counts each rank's fp32 payload."""
    stk, w = two_ranks["stk"], two_ranks["w"]
    want = mesh_fl.fedavg_sync(_torch(stk), torch.from_numpy(w))
    for r, (agg, nbytes) in enumerate(x[1] for x in two_ranks["out"]):
        for k in stk:
            assert np.array_equal(agg[k][0], want[k][r].numpy()), (k, r)
        assert nbytes == {"all-reduce": sum(4 * v[0].size
                                            for v in stk.values()),
                          "all-gather": 0}


def test_compressed_round_two_ranks_matches_the_reference(two_ranks):
    """phi3 SMOKE, C = 2, 2 local steps, lr 2e-4: each rank's round
    (`make_fl_round_step(compressed=True)` over the group) against the
    reference's pod of its index on the 2-pod mesh, at the multi-step
    bars; the ranks bit-identical."""
    cfg = jconfigs.get_config("phi3-mini-3.8b", smoke=True)
    params, batches = two_ranks["params"], two_ranks["batches"]
    mesh = _auto_mesh()
    step = jmesh_fl.make_fl_round_step(
        cfg, opt=LR, shard=JR.ShardingCtx(mesh, JR.make_rules("train")),
        local_steps=STEPS, compressed=True, mesh=mesh, n_pods=2)
    jp = jax.tree.map(jnp.asarray, params)
    stk = jmesh_fl.stack_params_for_clients(jp, C)
    mu = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), stk)
    with compat.set_mesh(mesh):
        want, _, jlosses = jax.jit(step)(
            stk, mu, jax.tree.map(jnp.asarray, batches),
            jnp.asarray(WEIGHTS))
    want, init = _np(want), _np(params)
    (agg0, loss0, bytes0), (agg1, loss1, bytes1) = [
        r[2] for r in two_ranks["out"]]
    assert np.abs(np.array([loss0, loss1]) - np.asarray(jlosses)).max() \
        <= LOSS_TOL
    flat0, flat1 = (dict(bridge.flatten_with_paths(a)) for a in (agg0, agg1))
    for k, ref in want.items():
        assert np.array_equal(flat0[k], flat1[k]), k
        update = np.abs(ref[0] - init[k]).max()
        ulp = np.finfo(np.float32).eps * np.abs(ref).max()
        assert np.abs(flat0[k][0] - ref[0]).max() <= 0.02 * update + 2 * ulp, k
    assert bytes0 == bytes1 == {"all-reduce": 0,
                                "all-gather": _ring_bytes(init.values(), 2)}


@pytest.mark.parametrize("n", [3, 4])
def test_compressed_ring_order_on_n_ranks(n, tmp_path):
    """n gloo ranks: rank r bit-equal to the numpy model's pod r, which
    adds the same terms as the others in its own order; the stacked path
    gives every pod's row, bit-equal too."""
    rng = np.random.RandomState(n)
    stk = {"w": (rng.randn(n, 8, 16) * 0.1).astype(np.float32),
           "b": (rng.randn(n, 33) * 0.1).astype(np.float32)}
    glob = {k: v[0] * np.float32(0.9) for k, v in stk.items()}
    w = np.arange(1.0, n + 1.0, dtype=np.float32)    # exact sum
    want = ring_model(stk, glob, w)
    out = mesh_ranks.spawn_ranks(mesh_ranks.aggregate_on_rank, n,
                                 str(tmp_path / "store"), stk, glob, w,
                                 True, "cpu")
    for r, (agg, nbytes) in enumerate(out):
        for k in stk:
            assert np.array_equal(agg[k][0], want[k][r]), (k, r)
        assert nbytes["all-gather"] == _ring_bytes(
            (v[0] for v in stk.values()), n)
    stacked = mesh_fl.fedavg_sync_compressed(_torch(stk), _torch(glob),
                                             torch.from_numpy(w), n_pods=n)
    for k in stk:
        assert np.array_equal(stacked[k].numpy(), want[k]), k


# ---------------------------------------------------------------------------
# The round step, stacked.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MODELS)
def test_round_step_stacked_matches_the_reference(arch):
    """C = 2 stacked clients, 2 local steps, lr 2e-4, weights [3, 1],
    against the reference's round step with `shard=INERT`: losses within
    2e-4, each leaf within the multi-step bar, every slot identical."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    rng = np.random.RandomState(0)
    batches = {k: rng.randint(0, cfg.vocab_size, (C, STEPS, B, S)
                              ).astype(np.int32) for k in ("tokens", "labels")}
    jstk = jmesh_fl.stack_params_for_clients(jp, C)
    jmu = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jstk)
    want, _, jlosses = jax.jit(jmesh_fl.make_fl_round_step(
        jcfg, opt=LR, shard=JR.INERT, local_steps=STEPS))(
        jstk, jmu, jax.tree.map(jnp.asarray, batches), jnp.asarray(WEIGHTS))

    stk = mesh_fl.stack_params_for_clients(params, C)
    mu = bridge.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32),
                         stk)
    step = mesh_fl.make_fl_round_step(cfg, LR, local_steps=STEPS)
    got, new_mu, losses = step(
        stk, mu, {k: torch.from_numpy(v).long() for k, v in batches.items()},
        torch.from_numpy(WEIGHTS))
    assert losses.shape == (C,) and new_mu.keys() == mu.keys()
    assert np.abs(losses.numpy() - np.asarray(jlosses)).max() <= LOSS_TOL
    share = SHARE.get(arch, 2e-2)
    init, want, got = _np(jstk), _np(want), _np(got)
    moved = 0.0
    for k, ref in want.items():
        assert np.array_equal(got[k][0], got[k][1]), k
        update = np.abs(ref[0] - init[k][0]).max()
        ulp = np.finfo(np.float32).eps * np.abs(ref).max()
        assert np.abs(got[k][0] - ref[0]).max() <= share * update + 2 * ulp, k
        moved += update
    assert moved > 0


def test_mesh_fl_lm_example_runs_and_holds_its_drift():
    assert mesh_fl_lm.main(["--device", "cpu"]) < 1e-5
