"""A whole run on the CPU (everything but the look for a card) with the
timed path broken underneath it, once for each fault a cell can have;
each must come out not correct, and the unbroken run correct.

The faults are planted in the port, as a later change could plant them:
a local step that returns its state unchanged; half of each batch left
out (the mean taken over the rest); one client's update left out of the
fold (the exchange between clients; one card has no exchange between
chips); the data layer's labels altered where they are produced; the
codec's answer altered where it is produced (the int8 arm)."""
import itertools

import pytest
import torch

import fedbench_tiny as tiny


def _unchanged(monkeypatch):
    from repro_torch.fl.training import TorchTrainerHooks
    real = TorchTrainerHooks._local_train

    def local_train(self, params, mu, batches):
        _, m, losses = real(self, params, mu, batches)
        from repro_torch.common.bridge import flatten_with_paths
        return ({k: v.detach().clone()
                 for k, v in flatten_with_paths(params)}, m, losses)

    monkeypatch.setattr(TorchTrainerHooks, "_local_train", local_train)


def _half_batch(monkeypatch):
    from repro_torch.models import lm
    real = lm.loss_fn

    def loss_fn(params, cfg, batch, aux_weight=0.01):
        half = batch["tokens"].shape[0] // 2
        return real(params, cfg, {k: v[:half] for k, v in batch.items()},
                    aux_weight)

    monkeypatch.setattr(lm, "loss_fn", loss_fn)


def _client_dropped(monkeypatch):
    from repro_torch.fl.training import TorchTrainerHooks
    real = TorchTrainerHooks._local_train
    calls = itertools.count()

    def local_train(self, params, mu, batches):
        new_p, m, losses = real(self, params, mu, batches)
        if next(calls) % len(self.clients) == len(self.clients) - 1:
            from repro_torch.common.bridge import flatten_with_paths
            new_p = {k: v.detach().clone()
                     for k, v in flatten_with_paths(params)}
        return new_p, m, losses

    monkeypatch.setattr(TorchTrainerHooks, "_local_train", local_train)


def _labels_altered(monkeypatch):
    from repro_torch.fl import training
    real = training.token_stream

    def token_stream(*a, **kw):
        for batch in real(*a, **kw):
            yield {"tokens": batch["tokens"], "labels": batch["tokens"]}

    monkeypatch.setattr(training, "token_stream", token_stream)


def _codec_altered(monkeypatch):
    from repro_torch.fl import training
    real = training.gq.dequantize

    def dequantize(*a, **kw):
        return 2.0 * real(*a, **kw)

    monkeypatch.setattr(training.gq, "dequantize", dequantize)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "client_dropped": _client_dropped,
          "labels_altered": _labels_altered, "codec_altered": _codec_altered}


def _run(tmp_path, monkeypatch, kind, arm, fault):
    torch.manual_seed(0)
    if fault is not None:
        FAULTS[fault](monkeypatch)
    root = tiny.lay_out(tmp_path, kind, arm)
    rc, line, _ = tiny.run_cell(root)
    assert rc == 0
    gaps = {k: v["value"] for k, v in line["compared"].items()}
    assert line["correct"] is (fault is None), gaps


@pytest.mark.parametrize("kind", ["attn", "mamba2"])
@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_fault_is_caught(tmp_path, monkeypatch, kind, fault):
    _run(tmp_path, monkeypatch, kind, "int8", fault)


@pytest.mark.parametrize("kind", ["attn", "mamba2"])
@pytest.mark.parametrize("fault", [None] + sorted(set(FAULTS)
                                                  - {"codec_altered"}))
def test_fault_is_caught_on_the_fp32_arm(tmp_path, monkeypatch, kind, fault):
    """The fp32 arm sends its updates without the codec, so it has every
    fault but the codec's."""
    _run(tmp_path, monkeypatch, kind, "fp32", fault)
