"""The port's CNN path against the JAX package on the CPU, part one: the
image data and partitioners (exact), the four CNNs' parameter trees,
logits and gradients at each one's `DATASET_SPECS` size (ResNets at
width 8), the bridge both ways, the optimizers and schedules, and the
device rule of the new entry points. Weights are drawn by the JAX
package and carried across by `common/bridge.py`; inputs come from a
numpy seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro.optim import optimizers as jopt
from repro_torch.common import bridge
from repro_torch.data import partition
from repro_torch.data import synthetic
from repro_torch.models import cnn
from repro_torch.optim import optimizers as opt

# model -> (dataset, the port's init, the JAX forward); the ResNets at
# width 8. The weights are drawn by the port and carried to the JAX
# package by the bridge (JAX's own draws cost seconds of compilation a
# model); `test_full_width_tree_is_the_jax_one` holds the trees' keys
# and shapes to the JAX package's init
MODELS = {
    "small_cnn": ("mnist", cnn.init_small_cnn, jcnn.small_cnn),
    "resnet18": ("cifar10",
                 lambda g, nc, ch: cnn.init_resnet(g, 18, nc, ch, width=8),
                 lambda p, x: jcnn.resnet(p, x, 18)),
    "resnet50": ("aireadi",
                 lambda g, nc, ch: cnn.init_resnet(g, 50, nc, ch, width=8),
                 lambda p, x: jcnn.resnet(p, x, 50)),
    "efficientnet": ("isic2019", cnn.init_efficientnet, jcnn.efficientnet),
}
PORT_FORWARD = {"small_cnn": cnn.small_cnn,
                "resnet18": lambda p, x: cnn.resnet(p, x, 18),
                "resnet50": lambda p, x: cnn.resnet(p, x, 50),
                "efficientnet": cnn.efficientnet}
# batch 8: at batch 2 the last ResNet stage normalises two values a
# channel (1x1 maps), and fp32 rounding in either package is amplified
# to 1e-3 of the logits, against float64
BATCH = 8
# The precision each model's gradient is compared in. resnet50's and
# efficientnet's fp32 gradients miss the 1e-4 bar against their own
# float64 ones, in either package: a ReLU or ReLU6 whose input lies
# within the forward's rounding of 0 passes or stops its element's
# gradient at random, and the batch norms below spread that over whole
# channels (`tools/cnn_fp32_spread.py` measures the port's at full
# width). So they are held in float64, where the bar resolves;
# small_cnn and resnet18 (at width 8, batch 8) hold it in fp32
GRAD_DTYPE = {"small_cnn": np.float32, "resnet18": np.float32,
              "resnet50": np.float64, "efficientnet": np.float64}


def _split_strides(name, tree):
    """A JAX tree without EfficientNet's int stride leaves, and a
    function putting them back, so `jax.grad` sees float leaves only."""
    if name != "efficientnet":
        return tree, lambda t: t
    strides = [s for _, s in tree["blocks"]]
    floats = dict(tree, blocks=[p for p, _ in tree["blocks"]])
    return floats, lambda t: dict(t, blocks=list(zip(t["blocks"], strides)))


def _np(tree, dtype=np.float32):
    """A JAX tree as numpy arrays of `dtype`, EfficientNet's int strides
    kept."""
    return jax.tree.map(
        lambda l: l if isinstance(l, int) else np.asarray(l).astype(dtype),
        tree)


def _ce(logp, y):
    return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1))


_CASES = {}


def _case(name):
    """(JAX params as numpy, port params, x, y, JAX logits) of `name` at
    its dataset's size, in fp32, built once."""
    if name not in _CASES:
        dataset, init, fwd = MODELS[name]
        img, ch, nc = jsyn.DATASET_SPECS[dataset]
        tp = init(torch.Generator().manual_seed(1), nc, ch)
        jp = bridge.cnn_params_to_numpy(tp, name)
        rng = np.random.RandomState(2)
        x = rng.randn(BATCH, img, img, ch).astype(np.float32)
        y = rng.randint(0, nc, BATCH).astype(np.int32)
        floats, join = _split_strides(name, jp)
        # x is an argument, not a constant XLA would fold at compile time
        logits = jax.jit(lambda fp, x: fwd(join(fp), x))(floats, x)
        _CASES[name] = (jp, tp, x, y, np.asarray(logits))
    return _CASES[name]


def _jax_grads(name, dtype):
    """The JAX package's loss and gradients of the float leaves of
    `name`'s case in `dtype` (float64 under `jax.enable_x64`)."""
    jp, _, x, y, _ = _case(name)
    floats, join = _split_strides(name, _np(jp, dtype))
    fwd = MODELS[name][2]

    def loss_fn(fp, x):
        return _ce(jax.nn.log_softmax(fwd(join(fp), x)), y)

    with jax.enable_x64(dtype == np.float64):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(floats,
                                                           x.astype(dtype))
        return float(loss), jax.tree.map(np.asarray, grads)


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dataset", sorted(jsyn.DATASET_SPECS))
def test_make_dataset_is_the_jax_one(dataset):
    got, want = synthetic.make_dataset(dataset, 40, seed=3), \
        jsyn.make_dataset(dataset, 40, seed=3)
    assert got.n_classes == want.n_classes and len(got) == len(want) == 40
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)
    assert got.x.dtype == np.float32 and got.y.dtype == np.int32


def test_minibatches_are_the_jax_ones():
    ds = synthetic.make_dataset("mnist", 300, seed=0)
    idx = np.arange(5, 290, 2)
    got = list(synthetic.minibatches(ds, idx, 32, seed=7))
    want = list(jsyn.minibatches(jsyn.make_dataset("mnist", 300, seed=0),
                                 idx, 32, seed=7))
    assert len(got) == len(want) == len(idx) // 32
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("n,clients,alpha_class,alpha_volume,seed", [
    (1500, 3, 1.0, 2.0, 0),      # the paper's MNIST row
    (900, 3, 2.0, 2.0, 0),       # the quickstart
    (5000, 6, 0.2, 0.5, 4),      # skewed classes and volumes
])
def test_dual_dirichlet_partition_is_the_jax_one(n, clients, alpha_class,
                                                 alpha_volume, seed):
    labels = np.random.RandomState(seed).randint(0, 10, n)
    got = partition.dual_dirichlet_partition(labels, clients, alpha_class,
                                             alpha_volume, seed=seed)
    want = jpart.dual_dirichlet_partition(labels, clients, alpha_class,
                                          alpha_volume, seed=seed)
    assert len(got) == len(want) == clients
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_natural_partition_is_the_jax_one():
    labels = np.zeros(1003)
    got = partition.natural_partition(labels, [0.5, 0.3, 0.15, 0.05], seed=2)
    want = jpart.natural_partition(labels, [0.5, 0.3, 0.15, 0.05], seed=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# Models.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,n_params", [
    ("small_cnn", 454_688), ("resnet18", 11_181_632),
    ("resnet50", 23_516_224), ("efficientnet", 3_279_872)])
def test_full_width_tree_is_the_jax_one(name, n_params):
    """`cnn.build`'s keys and shapes are the JAX package's at full width
    (EfficientNet's 16 int stride leaves aside)."""
    dataset = MODELS[name][0]
    img, ch, nc = jsyn.DATASET_SPECS[dataset]
    want = jax.eval_shape(
        lambda k: jcnn.build(name, k, nc, ch, img)[0], jax.random.PRNGKey(0))
    want = {k: tuple(s.shape) for k, s in bridge.flatten_with_paths(
        _split_strides(name, want)[0])}
    params, _, shape = cnn.build(name, torch.Generator().manual_seed(0), nc,
                                 ch, img, device="cpu")
    got = {k: tuple(t.shape) for k, t in bridge.flatten_with_paths(params)}
    assert got == want
    assert sum(t.numel() for t in bridge.leaves(params)) == n_params
    assert shape == (img, img, ch)


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_match_jax(name):
    _, tp, x, _, want = _case(name)
    with torch.no_grad():
        got = PORT_FORWARD[name](tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= 1e-4 * np.max(np.abs(want)), err


@pytest.mark.parametrize("name", list(MODELS))
def test_gradients_match_jax(name):
    """Each float leaf's gradient of the clients' cross-entropy, in
    `GRAD_DTYPE[name]`, within 1e-4 of its largest entry. EfficientNet's
    `bn_pw/bias` leaves have no gradient: each feeds a 1x1 conv and then
    a batch norm, which removes a shift, so theirs is float64 rounding
    in both packages; a leaf is held to at least 1e-9 of the model's
    largest entry."""
    dtype = GRAD_DTYPE[name]
    _, tp, x, y, _ = _case(name)
    want_loss, want = _jax_grads(name, dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    live = [t.to(tdt).requires_grad_(True) for t in bridge.leaves(tp)]
    logits = PORT_FORWARD[name](bridge.unflatten_as(tp, live),
                                torch.from_numpy(x).to(tdt))
    logp = torch.log_softmax(logits, -1)
    loss = -torch.mean(torch.gather(logp, 1,
                                    torch.from_numpy(y).long()[:, None]))
    grads = torch.autograd.grad(loss, live)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    got = bridge.cnn_params_to_numpy(bridge.unflatten_as(tp, grads), name)
    got = dict(bridge.flatten_with_paths(_split_strides(name, got)[0]))
    want = dict(bridge.flatten_with_paths(want))
    assert got.keys() == want.keys()
    top = max(np.max(np.abs(w)) for w in want.values())
    for k, w in want.items():
        assert got[k].dtype == dtype
        scale = max(np.max(np.abs(w)), 1e-9 * top)
        assert np.max(np.abs(got[k] - w)) <= 1e-4 * scale, k


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_round_trip_is_exact(name):
    jp = _case(name)[0]
    back = bridge.cnn_params_to_numpy(
        bridge.cnn_params_from_numpy(jp, name, device="cpu"), name)
    got, want = bridge.flatten_with_paths(back), bridge.flatten_with_paths(jp)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert type(g) is type(w), k       # strides come back as ints
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_bridge_checks_efficientnet_strides():
    jp = _case("efficientnet")[0]
    bad = dict(jp, blocks=[(p, 1) for p, _ in jp["blocks"]])
    with pytest.raises(ValueError, match="strides"):
        bridge.cnn_params_from_numpy(bad, "efficientnet", device="cpu")


def test_same_padding_is_xla_s():
    """Stride-2 SAME pads the odd row and column after the input."""
    assert cnn._same_pad(32, 7, 2) == (2, 3)
    assert cnn._same_pad(16, 3, 2) == (0, 1)
    assert cnn._same_pad(64, 3, 2) == (0, 1)
    assert cnn._same_pad(3, 3, 2) == (1, 1)
    assert cnn._same_pad(16, 1, 2) == (0, 0)
    assert cnn._same_pad(28, 5, 1) == (2, 2)


# ---------------------------------------------------------------------------
# Optimizers.
# ---------------------------------------------------------------------------
def _opt_trees(scale):
    rng = np.random.RandomState(5)
    shapes = {"a": (3, 3, 2, 8), "b": {"bias": (8,), "scale": (8,)},
              "c": [(40, 5), (5,)]}
    params = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda p: (rng.randn(*p.shape) * scale)
                          .astype(np.float32), params) for _ in range(3)]
    return params, grads


def _ulps_close(got, want, n):
    """Within `n` ulps of the leaf's largest entry: `p - lr m` and the
    like may round once (a fused multiply-add) or twice, so an entry that
    cancels to near 0 can differ by many of its own ulps."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
        return
    ulp = np.spacing(np.max(np.abs(want)))
    assert np.max(np.abs(got - want)) <= n * ulp, \
        np.max(np.abs(got - want)) / ulp


@pytest.mark.parametrize("name,kw,scale", [
    ("adamw", {}, 1.0),                                    # clipped
    ("adamw", {"clip_norm": None, "weight_decay": 0.1}, 0.01),
    ("sgd", {}, 1.0),
    ("sgd", {"clip_norm": 1.0}, 1.0),                      # clipped
])
def test_optimizer_steps_match_jax(name, kw, scale):
    """Three steps from identical grads (so the bias corrections move):
    parameters and state within 4 ulps."""
    params, grads = _opt_trees(scale)
    jo, po = jopt.get(name, lr=1e-2, **kw), opt.get(name, lr=1e-2, **kw)
    jp, js = jax.tree.map(jnp.asarray, params), jo.init(
        jax.tree.map(jnp.asarray, params))
    tp = bridge.tree_map(torch.from_numpy, params)
    ts = po.init(tp)
    jupdate = jax.jit(jo.update)
    for g in grads:
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = po.update(bridge.tree_map(torch.from_numpy, g), ts, tp)
    got = bridge.flatten_with_paths({"p": tp, "s": ts})
    want = bridge.flatten_with_paths({"p": jp, "s": js})
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        _ulps_close(g.numpy(), np.asarray(w), 4)


def test_clip_by_global_norm_matches_jax():
    params, grads = _opt_trees(3.0)
    g = grads[0]
    got, gn = opt.clip_by_global_norm(bridge.tree_map(torch.from_numpy, g),
                                      1.0)
    want, wn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    _ulps_close(gn.numpy(), np.asarray(wn), 2)
    for a, b in zip(bridge.leaves(got), jax.tree.leaves(want)):
        _ulps_close(a.numpy(), np.asarray(b), 4)


def test_schedules_match_jax():
    steps = np.array([0, 1, 5, 10, 11, 50, 99, 100, 150], np.int32)
    got = opt.cosine_schedule(3e-3, 10, 100)(torch.from_numpy(steps))
    want = jopt.cosine_schedule(3e-3, 10, 100)(jnp.asarray(steps))
    _ulps_close(got.numpy(), np.asarray(want), 2)
    c = opt.constant_schedule(1e-3)(torch.tensor(4, dtype=torch.int32))
    assert c.dtype == torch.float32 and float(c) == float(
        jopt.constant_schedule(1e-3)(jnp.asarray(4)))


# ---------------------------------------------------------------------------
# The device rule.
# ---------------------------------------------------------------------------
def _entry_points():
    from repro_torch.examples import paper_reproduction, quickstart
    from repro_torch.fl.client import FLClient
    from repro_torch.fl.server import FederatedServer, ServerTrainerHooks
    build = lambda device: cnn.build(  # noqa: E731
        "small_cnn", torch.Generator().manual_seed(0), 10, 1, 28,
        device=device)
    client = lambda device: FLClient(  # noqa: E731
        "c", cnn.small_cnn, opt.adamw(), lambda r: iter(()), 1,
        device=device)
    return {
        "cnn.build": build,
        "cnn_params_from_numpy": lambda device: bridge.cnn_params_from_numpy(
            bridge.cnn_params_to_numpy(cnn.init_small_cnn(
                torch.Generator()), "small_cnn"), "small_cnn", device=device),
        "FLClient": client,
        "ServerTrainerHooks": lambda device: ServerTrainerHooks(
            FederatedServer(build("cpu")[0]), {"c": client("cpu")},
            device=device),
        "quickstart": lambda device: quickstart.main(["--device", device]),
        "paper_reproduction": lambda device: paper_reproduction.main(
            ["--device", device]),
    }


@pytest.mark.parametrize("entry", ["cnn.build", "cnn_params_from_numpy",
                                   "FLClient", "ServerTrainerHooks",
                                   "quickstart", "paper_reproduction"])
def test_new_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs on it")
    fn = _entry_points()[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn("cuda")
    if entry not in ("quickstart", "paper_reproduction"):   # minutes on CPU
        fn("cpu")


def test_hooks_refuse_clients_on_another_device():
    from repro_torch.fl.client import FLClient
    from repro_torch.fl.server import FederatedServer, ServerTrainerHooks
    client = FLClient("c", cnn.small_cnn, opt.adamw(), lambda r: iter(()),
                      1, device="cpu")
    with pytest.raises(ValueError, match="not on meta"):
        ServerTrainerHooks(FederatedServer({}), {"c": client}, device="meta")
