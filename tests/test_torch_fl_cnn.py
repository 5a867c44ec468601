"""The port's CNN path against the JAX package on the CPU, part two: the
aggregation algorithms, checkpoints (byte for byte, and each package
restoring the other's), one local epoch of `FLClient` with fedavg and
fedprox, mid-epoch resume, `FederatedServer`, `ServerTrainerHooks`, and
the port's `FLCloudRunner` with `ServerTrainerHooks` against the JAX
runner with `JaxTrainerHooks` on the sync and the async_buffered
engine. Weights are drawn by the port and carried to the JAX package by
`common/bridge.py`; data come from the numpy generators both packages
share."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.checkpoint.store import MemoryStore as JaxMemoryStore
from repro.common import config as jax_config
from repro.data.partition import dual_dirichlet_partition
from repro.data.synthetic import make_dataset, minibatches
from repro.fl import algorithms as jalg
from repro.fl.client import FLClient as JaxClient
from repro.fl.runner import FLCloudRunner as JaxRunner
from repro.fl.server import FederatedServer as JaxServer, JaxTrainerHooks
from repro.models import cnn as jcnn
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.store import MemoryStore
from repro_torch.common import bridge
from repro_torch.common import config as port_config
from repro_torch.fl import algorithms as alg
from repro_torch.fl.client import FLClient
from repro_torch.fl.runner import FLCloudRunner as PortRunner
from repro_torch.fl.server import FederatedServer, ServerTrainerHooks
from repro_torch.models import cnn
from repro_torch.optim import optimizers as opt

N_IMAGES = 600          # three clients, the largest with 8 batches of 32


# ---------------------------------------------------------------------------
# Helpers.
# ---------------------------------------------------------------------------
def _model(name):
    """(port params, JAX params, port forward, JAX forward) of `name`
    from one draw; resnet18 at width 8."""
    gen = torch.Generator().manual_seed(0)
    if name == "small_cnn":
        tp = cnn.init_small_cnn(gen, 10, 1)
        fwd, jfwd = cnn.small_cnn, jcnn.small_cnn
    else:
        tp = cnn.init_resnet(gen, 18, 10, 3, width=8)
        fwd = lambda p, x: cnn.resnet(p, x, 18)        # noqa: E731
        jfwd = lambda p, x: jcnn.resnet(p, x, 18)      # noqa: E731
    jp = jax.tree.map(jnp.asarray, bridge.cnn_params_to_numpy(tp, name))
    return tp, jp, fwd, jfwd


_DATA = {}


def _data(dataset):
    if dataset not in _DATA:
        ds = make_dataset(dataset, N_IMAGES, seed=0)
        _DATA[dataset] = ds, dual_dirichlet_partition(ds.y, 3, alpha_class=2.0,
                                                      seed=0)
    return _DATA[dataset]


def _data_fn(ds, idx, i, dtype=np.float32):
    def batches(r):
        for x, y in minibatches(ds, idx, 32, seed=10 * r + i):
            yield x.astype(dtype), y
    return batches


_JAX_CLIENTS = {}


def _clients(name, algorithm="fedavg", store=None, jax_store=None,
             dtype=np.float32):
    """Port and JAX clients over the same shards, and the initial
    parameters, their forward and backward in `dtype`; the JAX clients
    (each of which compiles its own step) are built once per setting."""
    dataset = "mnist" if name == "small_cnn" else "cifar10"
    ds, parts = _data(dataset)
    tp, jp, fwd, jfwd = _model(name)
    tp = bridge.tree_map(lambda t: torch.from_numpy(t.numpy().astype(dtype)),
                         tp)
    jp = jax.tree.map(lambda a: np.asarray(a).astype(dtype), jp)
    port, jax_side = {}, {}
    for i, idx in enumerate(parts):
        port[f"c{i}"] = FLClient(
            f"c{i}", fwd, opt.adamw(lr=1e-3), _data_fn(ds, idx, i, dtype),
            len(idx), algorithm=algorithm, device="cpu", checkpoint_every=2,
            checkpointer=ckpt.Checkpointer(store) if store else None)
        key = (name, algorithm, i, dtype, jax_store is not None)
        if key not in _JAX_CLIENTS or jax_store is not None:
            _JAX_CLIENTS[key] = JaxClient(
                f"c{i}", jfwd, jopt.adamw(lr=1e-3),
                _data_fn(ds, idx, i, dtype), len(idx), algorithm=algorithm,
                checkpoint_every=2,
                checkpointer=jckpt.Checkpointer(jax_store) if jax_store
                else None)
        jax_side[f"c{i}"] = _JAX_CLIENTS[key]
    return tp, jp, port, jax_side


def _flat(tree, name="small_cnn"):
    if isinstance(bridge.leaves(tree)[0], torch.Tensor):
        tree = bridge.cnn_params_to_numpy(tree, name)
    return {k: np.asarray(v) for k, v in bridge.flatten_with_paths(tree)}


def _assert_epoch_close(got, want, init):
    """The multi-step bar: every parameter within 2% of its leaf's
    largest update plus 2 ulps of its largest entry, and a leaf the
    reference moves by more than an ulp moves here too."""
    got, want, init = _flat(got), _flat(want), _flat(init)
    assert got.keys() == want.keys()
    for k, w in want.items():
        update = np.max(np.abs(w - init[k]))
        ulp = np.spacing(np.max(np.abs(w)))
        assert update <= ulp or np.any(got[k] != init[k]), f"{k} did not move"
        err = np.max(np.abs(got[k] - w))
        assert err <= 2e-2 * update + 2 * ulp, (k, err, update)


def _ulps_close(got, want, n):
    """Within `n` ulps of each leaf's largest entry (a sum of products
    may round as fused multiply-adds or not)."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert np.max(np.abs(got[k] - w)) <= n * np.spacing(
            np.max(np.abs(w))), k


# ---------------------------------------------------------------------------
# Aggregation.
# ---------------------------------------------------------------------------
def _client_results(n=3, name="small_cnn"):
    tp, jp, _, _ = _model(name)
    rng = np.random.RandomState(4)
    flat = _flat(tp, name)
    outs = [bridge.unflatten({k: (v + rng.randn(*v.shape) * 1e-2 * (1 + i))
                              .astype(np.float32) for k, v in flat.items()})
            for i in range(n)]
    return ([bridge.tree_map(torch.from_numpy, o) for o in outs],
            [jax.tree.map(jnp.asarray, o) for o in outs], tp, jp)


@pytest.mark.parametrize("name,weights", [
    ("small_cnn", [3.0, 1.5, 2.0]), ("small_cnn", [117, 301, 64]),
    ("resnet18", [2.0, 1.0 / np.sqrt(4.0), 0.25])])
def test_weighted_average_matches_jax(name, weights):
    port, jax_side, _, _ = _client_results(name=name)
    _ulps_close(alg.weighted_average(port, weights),
                jalg.weighted_average(jax_side, weights), 2)


@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox", "fedavgm"])
def test_server_state_matches_jax_over_three_aggregations(algorithm):
    port, jax_side, tp, jp = _client_results()
    ps = alg.ServerState(tp, algorithm, server_momentum=0.7)
    js = jalg.ServerState(jp, algorithm, server_momentum=0.7)
    for r in range(3):
        ws = [100.0 + 17 * r, 60.0, 80.0 - 9 * r]
        ps.aggregate(port[r:] + port[:r], ws)
        js.aggregate(jax_side[r:] + jax_side[:r], ws)
        _ulps_close(ps.params, js.params, 2)


def test_fedprox_penalty_matches_jax():
    port, jax_side, tp, jp = _client_results(1)
    got = alg.fedprox_penalty(port[0], tp, 0.01)
    want = jalg.fedprox_penalty(jax_side[0], jp, 0.01)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(alg.fedprox_penalty(tp, tp, 0.1)) == 0.0


class _Fixed:
    """A duck-typed client returning a fixed update."""

    def __init__(self, value, n_samples, device):
        self.value, self.n, self.device = value, n_samples, device

    def train_epoch(self, params, round_idx):
        class M:
            loss, n_samples = 0.0, self.n
        return {"w": self.value}, M()


@pytest.mark.parametrize("staleness,want", [({"a": 0, "b": 3}, 10.0 / 3.5),
                                            (None, 3.5)])
def test_hooks_discount_stale_updates_as_the_jax_hooks_do(staleness, want):
    cpu = torch.device("cpu")
    server = FederatedServer({"w": torch.tensor(0.0)})
    hooks = ServerTrainerHooks(server, {
        "a": _Fixed(torch.tensor(2.0), 3, cpu),
        "b": _Fixed(torch.tensor(8.0), 1, cpu)}, device="cpu")
    jserver = JaxServer({"w": jnp.asarray(0.0)})
    jhooks = JaxTrainerHooks(jserver, {
        "a": _Fixed(jnp.asarray(2.0), 3, None),
        "b": _Fixed(jnp.asarray(8.0), 1, None)})
    for h in (hooks, jhooks):
        h.run_local("a", 0)
        h.run_local("b", 0)
        h.aggregate(["a", "b"], 0, staleness=staleness)
    assert float(server.params["w"]) == pytest.approx(want, rel=1e-6)
    assert float(server.params["w"]) == float(jserver.params["w"])
    assert ServerTrainerHooks.staleness_discount(3) == \
        JaxTrainerHooks.staleness_discount(3)


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------
def _train_states(name):
    """The same {"params", "opt_state", "batch"} train state as the port
    holds it and as the JAX package does."""
    tp, _, _, _ = _model(name)
    rng = np.random.RandomState(6)
    flat = _flat(tp, name)
    mu, nu = ({k: rng.randn(*v.shape).astype(np.float32)
               for k, v in flat.items()} for _ in range(2))
    port = {"params": tp, "batch": 6, "opt_state": opt.OptState(
        torch.tensor(6, dtype=torch.int32),
        bridge.tree_map(torch.from_numpy, bridge.unflatten(mu)),
        bridge.tree_map(torch.from_numpy, bridge.unflatten(nu)))}
    jax_side = {"params": jax.tree.map(jnp.asarray, bridge.unflatten(flat)),
                "batch": 6, "opt_state": jopt.OptState(
                    jnp.asarray(6, jnp.int32),
                    jax.tree.map(jnp.asarray, bridge.unflatten(mu)),
                    jax.tree.map(jnp.asarray, bridge.unflatten(nu)))}
    return port, jax_side


def _bits_equal(got, want):
    got = bridge.flatten_with_paths(got)
    want = bridge.flatten_with_paths(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("name", ["small_cnn", "resnet18"])
def test_serialized_train_state_is_the_jax_bytes(name):
    port, jax_side = _train_states(name)
    data = ckpt.serialize_pytree(port)
    assert data == jckpt.serialize_pytree(jax_side)
    header = json.loads(data[8:8 + int.from_bytes(data[:8], "little")])
    keys = [m["key"] for m in header["leaves"]]
    assert keys[:2] == ["batch", "opt_state/.step"]
    assert header["leaves"][0]["dtype"] == "int64"
    assert header["leaves"][1]["dtype"] == "int32"
    assert keys[2].startswith("opt_state/.mu/")
    assert keys[-1].startswith("params/")


@pytest.mark.parametrize("name", ["small_cnn", "resnet18"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_restores_the_other_s_checkpoint(name, writer):
    port, jax_side = _train_states(name)
    if writer == "port":
        got = jckpt.deserialize_into(jax_side, ckpt.serialize_pytree(port))
        _bits_equal(got, jax_side)
    else:
        got = ckpt.deserialize_into(port, jckpt.serialize_pytree(jax_side))
        _bits_equal(got, port)
        assert isinstance(got["opt_state"], opt.OptState)
        assert int(got["batch"]) == 6


def test_checkpointers_write_what_the_jax_ones_write():
    """`Checkpointer` and `ShardedCheckpointer` put the same objects under
    the same keys; `AsyncCheckpointer` lands every save; restores give
    the saved tree back."""
    port, jax_side = _train_states("small_cnn")
    stores = {}
    for pkg, mod, Store, tree in [("port", ckpt, MemoryStore, port),
                                  ("jax", jckpt, JaxMemoryStore, jax_side)]:
        store = Store()
        c = mod.Checkpointer(store)
        for s in (1, 5, 3):
            c.save(f"run/step={s}", tree)
        assert c.latest_step("run") == 5
        mod.ShardedCheckpointer(store, process_index=1).save("s1", tree)
        a = mod.AsyncCheckpointer(store, prefix="async")
        for i in range(4):
            a.save(f"r/step={i}", tree)
        a.wait()
        assert a.latest_step("r") == 3
        stores[pkg] = store
    keys = stores["jax"].list()
    assert stores["port"].list() == keys
    for k in keys:
        assert stores["port"].get(k) == stores["jax"].get(k), k
    _bits_equal(ckpt.Checkpointer(stores["port"]).restore("run/step=3", port),
                port)
    _bits_equal(ckpt.ShardedCheckpointer(stores["port"], process_index=1)
                .restore("s1", port), port)
    assert ckpt.Checkpointer(stores["port"]).restore("missing", port) is None


def test_bfloat16_and_scalar_leaves_round_trip_across_packages():
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16) * 1.5, "n": 7}}
    jtree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
             "b": {"c": jnp.ones(4, jnp.bfloat16) * 1.5, "n": 7}}
    assert ckpt.serialize_pytree(tree) == jckpt.serialize_pytree(jtree)
    out = ckpt.deserialize_into(tree, jckpt.serialize_pytree(jtree))
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert int(out["b"]["n"]) == 7


# ---------------------------------------------------------------------------
# Local training.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,algorithm,dtype", [
    ("small_cnn", "fedavg", np.float32), ("small_cnn", "fedprox", np.float32),
    ("resnet18", "fedavg", np.float64)])
def test_local_epoch_matches_jax(name, algorithm, dtype):
    """One `FLClient.train_epoch` of the largest client from the same
    weights (a fresh adamw state; the fedprox term against the round's
    global parameters): mean loss to 1e-5 and the multi-step bar.

    resnet18's forward and backward run in float64 (adamw computes in
    fp32 in both packages whatever the parameters' dtype). In fp32 two
    correct packages part ways within this epoch: a ReLU whose input
    lies within the forward's rounding of 0 passes or stops its
    gradient at random, adamw turns a small gradient's noise into a
    step as large as any, and the next forward sees other weights
    (`tools/cnn_fp32_spread.py` measures the port's fp32 epochs against
    its float64 ones)."""
    tp, jp, port, jax_side = _clients(name, algorithm, dtype=dtype)
    c = max(port, key=lambda n: port[n].n_samples)
    got, gm = port[c].train_epoch(tp, 1)
    with jax.enable_x64(dtype == np.float64):
        want, wm = jax_side[c].train_epoch(jax.tree.map(jnp.asarray, jp), 1)
        want = jax.tree.map(np.asarray, want)
    assert gm.n_batches == wm.n_batches >= 4
    assert gm.n_samples == wm.n_samples
    assert gm.loss == pytest.approx(wm.loss, rel=1e-5)
    assert bridge.leaves(got)[0].dtype == bridge.leaves(tp)[0].dtype
    _assert_epoch_close(got, want, tp)


def test_resume_mid_epoch_matches_the_reference_semantics():
    """The reference's `test_resume_from_checkpoint_mid_epoch`: after a
    full epoch with checkpoints every 2 batches, a resume skips the
    checkpointed batches and lands on the full epoch's parameters. The
    JAX client, resuming from the port's checkpoint, lands there too."""
    store, jstore = MemoryStore(), JaxMemoryStore()
    tp, jp, port, jax_side = _clients("small_cnn", store=store,
                                      jax_store=jstore)
    c = max(port, key=lambda n: port[n].n_samples)
    p_full, m = port[c].train_epoch(tp, 0)
    assert m.n_batches >= 4
    p_res, m2 = port[c].train_epoch(tp, 0, resume_from_batch=1)
    assert m2.n_batches < m.n_batches
    full, res = _flat(p_full), _flat(p_res)
    assert max(np.max(np.abs(full[k] - res[k])) for k in full) < 1e-4
    for k in store.list():
        jstore.put(k, store.get(k))
    want, wm = jax_side[c].train_epoch(jp, 0, resume_from_batch=1)
    assert wm.n_batches == m2.n_batches
    _assert_epoch_close(p_res, want, tp)


def test_federated_server_round_matches_jax():
    tp, jp, port, jax_side = _clients("small_cnn")
    server, jserver = FederatedServer(tp), JaxServer(jp)
    rec = server.run_round(list(port.values()), 0)
    want = jserver.run_round(list(jax_side.values()), 0)
    assert rec["round"] == want["round"] == 0
    assert rec["mean_client_loss"] == pytest.approx(
        want["mean_client_loss"], abs=2e-4)
    _assert_epoch_close(server.params, jserver.params, tp)


# ---------------------------------------------------------------------------
# The runner.
# ---------------------------------------------------------------------------
def _run(runner, C, hooks, engine, parts, record_to):
    clients = tuple(C.ClientProfile(f"c{i}", mean_epoch_s=300.0 * (i + 1),
                                    jitter=0.0, n_samples=len(idx))
                    for i, idx in enumerate(parts))
    cfg = C.FLRunConfig(dataset="mnist", clients=clients, n_epochs=2,
                        policy="fedcostaware", seed=0, engine=engine)
    return runner(cfg, hooks=hooks, record_to=record_to).run()


@pytest.mark.parametrize("engine", [None, "async_buffered"])
def test_cloud_runner_with_server_hooks_matches_jax(engine, tmp_path):
    """The port's runner over `ServerTrainerHooks` against the JAX
    runner over `JaxTrainerHooks`, both training small_cnn for real:
    dollars to 1e-9, the event trace byte for byte, each aggregation's
    mean client loss to 2e-4 and the global model at the multi-step bar."""
    tp, jp, port, jax_side = _clients("small_cnn")
    parts = _data("mnist")[1]
    server, jserver = FederatedServer(tp), JaxServer(jp)
    got = _run(PortRunner, port_config,
               ServerTrainerHooks(server, port, device="cpu"), engine, parts,
               tmp_path / "port.events.jsonl")
    want = _run(JaxRunner, jax_config, JaxTrainerHooks(jserver, jax_side),
                engine, parts, tmp_path / "jax.events.jsonl")
    assert got.total_cost == pytest.approx(want.total_cost, abs=1e-9)
    assert got.per_round_participants == want.per_round_participants
    assert (tmp_path / "port.events.jsonl").read_bytes() == \
        (tmp_path / "jax.events.jsonl").read_bytes()
    assert [r["round"] for r in server.history] == \
        [r["round"] for r in jserver.history]
    np.testing.assert_allclose(
        [r["mean_client_loss"] for r in server.history],
        [r["mean_client_loss"] for r in jserver.history], atol=2e-4)
    _assert_epoch_close(server.params, jserver.params, tp)
