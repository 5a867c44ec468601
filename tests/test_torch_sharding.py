"""The port's sharding and dry-run layer against the JAX package's, on
the CPU with no device memory: `sharding/rules.py::resolve_spec` on every
leaf of every FULL config (single-pod, multi-pod and CPU meshes; train
rules with each config's overrides, decode rules), the spec trees of
`launch/steps.py` on every dry-run cell, the abstract parameter and cache
trees of `models/lm.py`, `configs/shapes.py::input_specs`, and
`launch/roofline.py`'s model-FLOPs yardstick. The JAX side resolves on
`jax.sharding.AbstractMesh`es of the production shapes, so no devices
are needed; a spec is compared as the tuple of its `PartitionSpec`."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.common.config import SHAPES as JSHAPES
from repro.configs import shapes as jshapes
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.sharding import rules as JR
from repro_torch import configs
from repro_torch.common.config import SHAPES
from repro_torch.configs import shapes
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline, steps
from repro_torch.models import lm
from repro_torch.sharding import rules as R

MESHES = {"single": M.make_production_mesh(multi_pod=False),
          "multi": M.make_production_mesh(multi_pod=True),
          "cpu": M.make_cpu_mesh()}
CELLS = configs.all_cells()


def _jmesh(name):
    m = MESHES[name]
    return AbstractMesh(m.sizes, m.axis_names)


def _leaves(tree, is_leaf, prefix=""):
    """(key, leaf) of nested dicts, `/`-joined keys, in sorted order."""
    if is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _leaves(tree[k], is_leaf, f"{prefix}/{k}" if prefix else k)
    return out


def _jspecs(tree):
    """A tree of JAX NamedShardings -> {key: spec tuple}."""
    return {k: tuple(s.spec) for k, s in
            _leaves(tree, lambda x: hasattr(x, "spec"))}


def _specs(tree):
    return dict(_leaves(tree, R.is_spec))


def _jaxes(tree):
    return dict(_leaves(tree, lambda x: isinstance(x, tuple)))


def _rules(cfg, kind):
    overrides = dict(cfg.sharding_overrides or ()) if kind == "train" else {}
    return overrides


def test_rule_tables_are_the_jax_package_s():
    assert R.TRAIN_RULES == JR.TRAIN_RULES
    assert R.DECODE_RULES == JR.DECODE_RULES
    assert R._CLAIM_PRIORITY == JR._CLAIM_PRIORITY
    for kind in ("train", "prefill", "decode"):
        assert R.make_rules(kind) == JR.make_rules(kind)


def test_production_meshes():
    assert MESHES["single"].shape == {"data": 16, "model": 16}
    assert MESHES["multi"].shape == {"pod": 2, "data": 16, "model": 16}
    assert MESHES["multi"].axis_names == ("pod", "data", "model")
    assert [M.mesh_chips(m) for m in MESHES.values()] == [256, 512, 1]
    for name in MESHES:
        assert dict(_jmesh(name).shape) == MESHES[name].shape


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_resolve_spec_of_every_param_is_the_jax_package_s(arch, mesh, kind):
    """Every leaf of the FULL config, with and without its shape (the
    divisibility drops), under train rules with the config's overrides
    and under decode rules."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    rules = R.make_rules(kind, _rules(cfg, kind))
    jrules = JR.make_rules(kind, _rules(jcfg, kind))
    assert rules == jrules
    axes = dict(_leaves(lm.logical_axes(cfg), R.is_spec))
    jaxes = _jaxes(jlm.logical_axes(jcfg))
    assert axes == jaxes
    shp = {k: tuple(v.shape) for k, v in
           _leaves(lm.abstract_params(cfg), lambda x: hasattr(x, "shape"))}
    for k, ax in axes.items():
        for shape in (None, shp[k]):
            got = R.resolve_spec(ax, rules, MESHES[mesh], shape)
            want = JR.resolve_spec(ax, jrules, _jmesh(mesh), shape)
            assert got == tuple(want), (k, shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_spec_trees_of_every_cell_are_the_jax_package_s(arch, shape, mesh):
    """`param_shardings`, `opt_shardings`, `batch_shardings` (the decode
    cache's specs included) and `step_for`'s input and output trees."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    sh, jsh = SHAPES[shape], JSHAPES[shape]
    kind = sh.kind
    rules = R.make_rules(kind, _rules(cfg, kind))
    jrules = JR.make_rules(kind, _rules(jcfg, kind))
    m, jm = MESHES[mesh], _jmesh(mesh)
    pspec = steps.param_shardings(cfg, rules, m)
    assert _specs(pspec) == _jspecs(jsteps.param_shardings(jcfg, jrules, jm))
    bspec = steps.batch_shardings(cfg, rules, m, kind, sh)
    assert _specs(bspec) == _jspecs(
        jsteps.batch_shardings(jcfg, jrules, jm, kind, jsh))
    ospec = steps.opt_shardings(cfg, rules, m)
    jo = jsteps.opt_shardings(jcfg, jrules, jm)
    assert ospec.step == tuple(jo.step.spec)
    assert _specs(ospec.mu) == _jspecs(jo.mu) == _specs(pspec)

    _, ins, outs = steps.step_for(cfg, sh, m)
    assert ins[0] == pspec
    if kind == "train":
        assert ins[1:] == (ospec, bspec["batch"]) and outs == (pspec, ospec, ())
    elif kind == "prefill":
        names = ["tokens"] + (["cond"] if cfg.family == "vlm" else [])
        assert list(ins[1:]) == [bspec[n] for n in names]
        assert outs == R.resolve_spec(("batch", "vocab"), rules, m,
                                      (sh.global_batch, cfg.vocab_size))
    else:
        assert ins[1:] == (bspec["tokens"], bspec["pos"], bspec["cache"])
        assert outs[1] == bspec["cache"]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_abstract_trees_are_the_jax_package_s(arch):
    """`abstract_params` and `abstract_cache` in keys, shapes and dtypes,
    `logical_axes`, `cache_logical_axes` and `param_count`."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)

    def shapes_of(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in _leaves(tree, lambda x: hasattr(x, "shape"))}

    got = lm.abstract_params(cfg)
    assert all(t.device.type == "meta" for _, t in
               _leaves(got, lambda x: hasattr(x, "shape")))
    assert shapes_of(got) == shapes_of(jlm.abstract_params(jcfg))
    assert lm.param_count(cfg) == jlm.param_count(jcfg)
    assert _specs(lm.cache_logical_axes(cfg)) == _jaxes(
        jlm.cache_logical_axes(jcfg))
    for B, S in ((128, 32_768), (1, 524_288), (3, 5)):
        assert shapes_of(lm.abstract_cache(cfg, B, S)) == shapes_of(
            jlm.abstract_cache(jcfg, B, S))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_model_flops_are_the_jax_package_s(arch, shape):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)

    def shapes_of(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in _leaves(tree, lambda x: hasattr(x, "shape"))}

    got = shapes.input_specs(cfg, SHAPES[shape])
    assert shapes_of(got) == shapes_of(
        jshapes.input_specs(jcfg, JSHAPES[shape]))
    assert all(t.device.type == "meta" for _, t in
               _leaves(got, lambda x: hasattr(x, "shape")))
    for got, want in [
            (roofline.active_param_count(cfg),
             jroofline.active_param_count(jcfg)),
            (roofline.model_flops(cfg, SHAPES[shape]),
             jroofline.model_flops(jcfg, JSHAPES[shape]))]:
        assert got == pytest.approx(want, rel=1e-12, abs=0)


def test_cells_and_shapes_are_the_jax_package_s():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert configs.all_cells() == jconfigs.all_cells()
    assert configs.skipped_cells() == jconfigs.skipped_cells()
    for arch in configs.ARCH_IDS:
        assert configs.applicable_shapes(arch) == \
            jconfigs.applicable_shapes(arch)


@pytest.mark.parametrize("mesh", [None, "cpu", "multi"])
def test_sharding_ctx_is_an_identity(mesh):
    ctx = (R.INERT if mesh is None
           else R.ShardingCtx(MESHES[mesh], R.make_rules("train")))
    x = torch.arange(12.0).reshape(3, 4)
    assert ctx(x, "batch", "embed_act") is x
    assert ctx.active == (mesh is not None)
    assert R.ShardingCtx(MESHES["cpu"]).active is False


def test_shard_factor_counts_the_pieces():
    m = MESHES["multi"]
    assert R.shard_factor((), m) == 1
    assert R.shard_factor((None, "model"), m) == 16
    assert R.shard_factor((("pod", "data"), None, "model"), m) == 512
