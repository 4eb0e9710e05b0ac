"""Shared pieces of the benchmark's CPU tests: a tiny model and tiny
traffic of each loop, on the port's plain paths."""

import pytest
import torch

from bench_port import loops, model


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


def tiny_dims() -> model.Dims:
    """Two layers of 128 (four heads of 32, groups of 128 along K as at
    full width), a vocabulary of 4001 (odd, so the table stays int4 per
    column as at full width)."""
    cfg = model.load_config("gpt2-small-w4a8")
    cfg.update(n_layer=2, n_embd=128, n_head=4, vocab_size=4001)
    cfg["assumed"] = dict(cfg["assumed"], max_sequence_length=128)
    return model.Dims.from_json(cfg)


SERVE = {"page_size": 16, "max_chunk": 32, "attn_act_bits": 16,
         "num_steps": [4, 8, 16], "num_steps_weights": [1, 2, 1]}
TINY = {
    "backlog": dict(loop="backlog", slots=2, seq_len=64,
                    request_len=[16, 64, 16], queue_depth=2,
                    check_requests=2, attend_mode="paged", **SERVE),
    "open": dict(loop="open", slots=4, seq_len=64, request_len=[16, 64, 16],
                 rate_per_s=20.0, check_requests=4,
                 attend_mode="dense", **SERVE),
    "sampler": dict(loop="sampler", batch=2, seq_len=32, num_steps=4,
                    warm_calls=1, check_among=2),
}


@pytest.fixture
def tiny(monkeypatch):
    """(dims, traffic by loop), with a warm-up short enough for a test."""
    torch.manual_seed(0)
    monkeypatch.setattr(loops, "WARM_OPEN_S", 1.0)
    return tiny_dims(), TINY
