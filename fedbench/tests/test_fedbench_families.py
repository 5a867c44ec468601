"""The model families (`fedbench/families/`), each a file found by the
`"family"` key of a configuration file.

The two families are held to what the benchmark read before it had
family files (values computed then and written here): their schemas and
port configurations at full size, the weights made from a seed and the
reference's loss and gradients at a tiny size. A family that only a
temporary benchmark root holds (`data/families/hybrid.py`, two kinds of
layer in one block) runs a whole cell, which shows that a new family is
files and entries alone."""
import ast
import hashlib
import json

import pytest
import torch

import fedbench_tiny as tiny

from fedbench.harness import spec as S, weights
from fedbench.reference import model as M

DATA = tiny.BENCH / "tests" / "data"
FAMILIES = sorted((tiny.BENCH / "families").glob("*.py")) \
    + [DATA / "families" / "hybrid.py"]
INTERFACE = ("dims", "schema", "INITS", "loss", "model_flops", "port_config")


def _digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


def _full(name):
    spec = S.benchmark()
    cfg = S.config(spec, name)
    return S.family(cfg), cfg


# (entries, digest of the entries' repr; digest of the port's
# ModelConfig's repr)
FULL = {"phi3-mini-3.8b-d16": (12, "3d2406ef98ddbcaf", "5c69d233b1ca4c70"),
        "mamba2-1.3b": (15, "e9cb55a039dd87c4", "1f6f3f489ed3356f")}


@pytest.mark.parametrize("name", sorted(FULL))
def test_schema_is_the_one_before_families(name):
    fam, cfg = _full(name)
    entries = fam.schema(cfg)
    assert (len(entries), _digest(entries)) == FULL[name][:2]


@pytest.mark.parametrize("name", sorted(FULL))
def test_port_config_is_the_one_before_families(name):
    fam, cfg = _full(name)
    assert _digest(fam.port_config(cfg)) == FULL[name][2]


# a leaf's (sum, sum of squares) in float64, of the weights made from the
# seed 2**31 + 3 at the tiny sizes
WEIGHTS = json.loads((DATA / "weights_before_families.json").read_text())


@pytest.mark.parametrize("kind", ["attn", "mamba2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_are_the_ones_before_families(kind, dtype):
    cfg = tiny.tiny_config(kind, dtype)
    got = weights.make(S.family(cfg), cfg, 2 ** 31 + 3, "cpu")
    want = WEIGHTS[f"{kind} {dtype}"]
    assert list(got) == list(want)
    for key, x in got.items():
        stats = [float(x.double().sum()), float(x.double().square().sum())]
        assert stats == pytest.approx(want[key], rel=1e-6, abs=1e-9), key


# the mean loss and each leaf's gradient norm of one batch
LOSS = {"attn": 4.990609169006348, "mamba2": 4.846432685852051}
GRAD_NORMS = json.loads((DATA / "grads_before_families.json").read_text())


@pytest.mark.parametrize("kind", ["attn", "mamba2"])
def test_reference_loss_and_gradients_are_the_ones_before_families(kind):
    cfg = tiny.tiny_config(kind)
    fam = S.family(cfg)
    params = {k: v.float().requires_grad_(True) for k, v in
              weights.make(fam, cfg, 2 ** 31 + 5, "cpu").items()}
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, 125, (2, 16), generator=g)
    labels = torch.randint(0, 125, (2, 16), generator=g)
    loss = fam.loss(params, cfg, tokens, labels, M.Precision())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert float(loss.detach()) == pytest.approx(LOSS[kind], rel=1e-6)
    norms = {k: float(x.double().norm()) for k, x in zip(params, grads)}
    assert norms == pytest.approx(GRAD_NORMS[kind], rel=1e-5)


def _imports_the_port(node) -> bool:
    if isinstance(node, ast.Import):
        return any(a.name.split(".")[0] == "repro_torch" for a in node.names)
    return isinstance(node, ast.ImportFrom) and node.level == 0 \
        and node.module.split(".")[0] == "repro_torch"


@pytest.mark.parametrize("path", FAMILIES, ids=lambda p: p.stem)
def test_a_family_file_has_the_interface_and_touches_the_port_in_port_config(
        path):
    """Each family file has the interface, and only its `port_config`
    imports the port: its reference imports nothing of the program."""
    fam = S._module(path, f"family_{path.stem}")
    for name in INTERFACE:
        assert hasattr(fam, name), (path.stem, name)
    tree = ast.parse(path.read_text())
    assert not any(_imports_the_port(n) for n in tree.body)
    where = {fn.name for fn in ast.walk(tree)
             if isinstance(fn, ast.FunctionDef)
             and any(_imports_the_port(n) for n in ast.walk(fn))}
    assert where == {"port_config"}, where


@pytest.mark.parametrize("cfg, missing", [
    ({"name": "x", "family": "no_such_family"}, "no_such_family.py"),
    ({"name": "x"}, "names no family")])
def test_an_unknown_family_is_a_spec_error_that_names_it(cfg, missing):
    with pytest.raises(S.SpecError, match=missing):
        S.family(cfg)


def test_lay_out_links_the_families(tmp_path):
    root = tiny.lay_out(tmp_path, "mamba2")
    bench = root / "fedbench"
    assert (bench / "families").resolve() == \
        (tiny.BENCH / "families").resolve()
    cfg = json.loads((bench / "configs" / "c.json").read_text())
    assert S.family(cfg, bench).schema(cfg) == \
        S.family(cfg).schema(cfg)


@pytest.mark.parametrize("arm", ["int8", "fp32"])
def test_a_new_family_is_files_only(tmp_path, arm):
    """A benchmark root whose only family is the tests' two-kind block:
    the cell's first round agrees with the reference at float32."""
    cfg = json.loads((DATA / "hybrid-tiny.json").read_text())
    root = tiny.lay_out(tmp_path, None, arm=arm, config=cfg,
                        families=DATA / "families")
    assert [p.name for p in (root / "fedbench" / "families").iterdir()
            if p.suffix == ".py"] == ["hybrid.py"]
    rc, line, err = tiny.run_cell(root)
    assert rc == 0, err
    gaps = {k: v["value"] for k, v in line["compared"].items()}
    assert line["correct"] is True, gaps
