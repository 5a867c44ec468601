"""The port's step functions and drivers (`repro_torch.launch`) against
the JAX package's `launch/` on the CPU, at SMOKE sizes in fp32: one
AdamW train step with `grad_accum` 1 and 2, gradient accumulation
against one whole batch, the prefill and decode steps, the serving
driver's greedy tokens against a JAX greedy loop, the training driver's
checkpoint and restart (bit for bit against an uninterrupted run), and
a resume from the JAX driver's own checkpoint."""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.checkpoint.store import FileStore
from repro_torch.common import bridge
from repro_torch.launch import serve, steps, train
from repro_torch.models import lm

from test_models import make_batch

ARCH = "phi3-mini-3.8b"
MODELS = ["phi3-mini-3.8b", "mamba2-1.3b", "recurrentgemma-2b",
          "granite-moe-3b-a800m"]
# the multi-step bars of ROADMAP §3 (tests/test_torch_training.py): lr
# 2e-4, losses within 2e-4, every leaf within 2% of its update plus 2
# ulps of its largest entry. AdamW's first step moves an element by about
# lr * g / (|g| + 1e-8) whatever the size of its gradient g, so an element
# whose gradient lies within the gradient bar (1e-4 of the leaf's largest,
# tests/test_torch_models.py) of zero has no settled step: phi3 SMOKE has
# a few per leaf at 1e-10 to 1e-8, whose steps two fp32 runs put up to
# 10% of lr apart. A first step's bar leaves those elements out; the
# gradients themselves are held at the gradient bar
LR, LOSS_TOL, SHARE, GRAD_TOL = 2e-4, 2e-4, 2e-2, 1e-4
BATCH, SEQ = 4, 16


def _pair(arch=ARCH):
    return (jconfigs.get_config(arch, smoke=True),
            configs.get_config(arch, smoke=True))


def _flat(tree):
    return dict(bridge.flatten_with_paths(tree))


def _np(tree):
    return {k: bridge._to_numpy(v) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in _flat(tree).items()}


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jlm.init_params(cfg, jax.random.PRNGKey(seed)))


def _assert_updates_close(got, want, init, what, grads=None):
    """Every leaf of `got` within SHARE of its update from `init` in
    `want`, plus 2 ulps of its largest entry; with `grads`, an AdamW first
    step's, only where the gradient is over GRAD_TOL of its largest."""
    assert set(got) == set(want), what
    for k, w in want.items():
        update = np.max(np.abs(w - init[k]))
        ulp = np.finfo(w.dtype).eps * np.max(np.abs(w))
        err = np.abs(got[k] - w)
        if grads is not None:
            g = np.abs(grads[k])
            err = err[g > GRAD_TOL * np.max(g)]
        assert np.max(err) <= SHARE * update + 2 * ulp, (what, k, update)


def _token_batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    jcfg, cfg = _pair()
    jcfg = dataclasses.replace(jcfg, grad_accum=accum)
    cfg = dataclasses.replace(cfg, grad_accum=accum)
    jp = _jax_params(jcfg)
    batch = _token_batch(cfg)

    jstep, jopt = jsteps.make_train_step(jcfg, lr=LR)
    jparams = jax.tree.map(jnp.asarray, jp)
    jnew, jstate, jmetrics = jax.jit(jstep)(
        jparams, jopt.init(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})

    step, opt = steps.make_train_step(cfg, lr=LR)
    params = bridge.params_from_numpy(jp, cfg, device="cpu")
    new, state, metrics = step(params, opt.init(params),
                               {k: torch.from_numpy(v).long()
                                for k, v in batch.items()})
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= LOSS_TOL
    assert int(state.step) == int(jstate.step) == 1
    # the first moments are 0.1 of the (clipped) fp32 gradients
    jmu = _np(jax.tree.map(np.asarray, jstate.mu))
    for k, m in _np(state.mu).items():
        assert m.dtype == np.float32
        assert np.max(np.abs(m - jmu[k])) <= GRAD_TOL * np.max(np.abs(jmu[k])), k
    _assert_updates_close(_np(new), _np(jax.tree.map(np.asarray, jnew)),
                          _flat(jp), f"accum {accum}", grads=jmu)


def test_accumulation_matches_one_batch():
    """Two micro-batches of 2 against one batch of 4: the same mean loss
    and, within the bars, the same step (phi3 has no MoE, whose
    load-balancing loss depends on the batch split)."""
    _, cfg = _pair()
    batch = {k: torch.from_numpy(v).long()
             for k, v in _token_batch(cfg, seed=1).items()}
    params = lm.init_params(cfg, 0, "cpu")
    init = _np(params)
    out = {}
    for accum in (1, 2):
        step, opt = steps.make_train_step(
            dataclasses.replace(cfg, grad_accum=accum), lr=LR)
        out[accum] = step(params, opt.init(params), batch)
    assert abs(float(out[2][2]["loss"]) - float(out[1][2]["loss"])) <= 1e-6
    _assert_updates_close(_np(out[2][0]), _np(out[1][0]), init, "accum",
                          grads=_np(out[1][1].mu))
    assert _np(params).keys() == init.keys()
    for k, v in _np(params).items():            # the step left them alone
        assert np.array_equal(v, init[k]), k


@pytest.mark.parametrize("arch", MODELS)
def test_prefill_and_decode_steps_match_jax(arch):
    jcfg, cfg = _pair(arch)
    jp = _jax_params(jcfg)
    jpj = jax.tree.map(jnp.asarray, jp)
    params = bridge.params_from_numpy(jp, cfg, device="cpu")
    toks = np.array(make_batch(jcfg, 2, 8, seed=2)["tokens"])

    want = jax.jit(jsteps.make_prefill_step(jcfg))(jpj, jnp.asarray(toks))
    got = steps.make_prefill_step(cfg)(params, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)

    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    decode = steps.make_decode_step(cfg)
    jcache = jlm.init_cache(jcfg, 2, 8)
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        pos = np.full((2,), t, np.int32)
        jtok, jcache = jdecode(jpj, jnp.asarray(toks[:, t:t + 1]),
                               jnp.asarray(pos), jcache)
        tok, cache = decode(params, torch.from_numpy(toks[:, t:t + 1]).long(),
                            torch.from_numpy(pos).long(), cache)
        assert tok.tolist() == np.asarray(jtok).tolist(), (arch, t)
    jflat = _np(jax.tree.map(np.asarray, jcache))
    for k, leaf in _np(cache).items():
        np.testing.assert_allclose(leaf, jflat[k], rtol=0, err_msg=k,
                                   atol=1e-3 * np.max(np.abs(jflat[k])))


def _jax_greedy(jcfg, jp, batch, prompt_len, gen):
    """The JAX package's `launch/serve.py` loop: a RandomState(0) prompt
    through `decode_step` one token at a time, then greedy tokens."""
    rng = np.random.RandomState(0)
    prompt = jnp.asarray(rng.randint(0, jcfg.vocab_size, (batch, prompt_len)),
                         jnp.int32)
    step = jax.jit(lambda p, t, pos, c: jlm.decode_step(p, jcfg, t, pos, c))
    cache = jlm.init_cache(jcfg, batch, prompt_len + gen)
    for t in range(prompt_len):
        logits, cache = step(jp, prompt[:, t:t + 1],
                             jnp.full((batch,), t, jnp.int32), cache)
    outs = []
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(gen):
        outs.append(tok)
        logits, cache = step(jp, tok, jnp.full((batch,), prompt_len + i,
                                              jnp.int32), cache)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    return np.asarray(prompt), np.asarray(jnp.concatenate(outs, axis=1))


@pytest.mark.parametrize("arch", ["glm4-9b"] + MODELS)
def test_serve_matches_a_jax_greedy_loop(arch):
    """The driver's defaults (batch 4, a prompt of 16, 32 greedy tokens)
    on the JAX package's weights."""
    jcfg, cfg = _pair(arch)
    jp = _jax_params(jcfg)
    want_prompt, want = _jax_greedy(jcfg, jax.tree.map(jnp.asarray, jp),
                                    4, 16, 32)
    out = serve.serve(cfg, bridge.params_from_numpy(jp, cfg, device="cpu"),
                      4, 16, 32, device="cpu", log=lambda s: None)
    assert out["prompt"].tolist() == want_prompt.tolist()
    assert out["tokens"].tolist() == want.tolist()


def _run(tmp, steps_, ckpt_dir="", **kw):
    _, cfg = _pair()
    return train.train(cfg, ARCH, steps_, BATCH, SEQ, LR,
                       ckpt_dir=str(ckpt_dir) if ckpt_dir else "",
                       ckpt_every=2, device="cpu", log=lambda s: None, **kw)


def test_restart_is_bit_exact(tmp_path):
    """Stopped after step 2's checkpoint and restarted, training reaches
    step 4 with the parameters, optimizer state and losses of a run that
    never stopped, bit for bit."""
    whole = _run(tmp_path, 4)
    first = _run(tmp_path, 2, tmp_path / "ck")
    resumed = _run(tmp_path, 4, tmp_path / "ck")
    assert first["start_step"] == 0 and resumed["start_step"] == 2
    assert first["losses"] + resumed["losses"] == whole["losses"]
    got = _np({"params": resumed["params"], "opt": resumed["opt"]})
    want = _np({"params": whole["params"], "opt": whole["opt"]})
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert Checkpointer(FileStore(str(tmp_path / "ck"))).latest_step(ARCH) == 4


def test_resumes_a_jax_checkpoint(tmp_path):
    """The JAX driver trains 4 steps with a checkpoint every 2; the port
    resumes from the JAX step-2 checkpoint alone and reaches the JAX
    step 4 within the multi-step bars."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jtrain.main(["--arch", ARCH, "--steps", "4", "--batch", str(BATCH),
                 "--seq", str(SEQ), "--lr", str(LR), "--ckpt-dir", str(jdir),
                 "--ckpt-every", "2", "--log-every", "4"])
    pdir.mkdir()
    shutil.copy(jdir / f"ckpt__{ARCH}__step=2", pdir)
    out = _run(tmp_path, 4, pdir)
    assert out["start_step"] == 2 and len(out["losses"]) == 2

    template = {"params": out["params"], "opt": out["opt"]}
    ck = Checkpointer(FileStore(str(jdir)))
    j2 = _np(ck.restore(f"{ARCH}/step=2", template))
    j4 = _np(ck.restore(f"{ARCH}/step=4", template))
    got = _np(template)
    assert got["opt/.step"] == j4["opt/.step"] == 4
    _assert_updates_close(
        {k: v for k, v in got.items() if k.startswith("params/")},
        {k: v for k, v in j4.items() if k.startswith("params/")}, j2,
        "resumed from the JAX checkpoint")


def test_mains_run_on_the_cpu(tmp_path, capsys):
    argv = ["--steps", "2", "--batch", "2", "--seq", "8", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1", "--log-every",
            "1"]
    train.main(argv)
    train.main(argv[:1] + ["3"] + argv[2:])
    serve.main(["--arch", "mamba2-1.3b", "--batch", "2", "--prompt-len", "4",
                "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 2" in out
    assert out.count("done.") == 2 and "ms/token" in out


def test_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs on it")
    _, cfg = _pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(cfg, ARCH, 1, 2, 8, LR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve(cfg, None, 1, 2, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
