"""Generated tokens a second of the one-shot sampler over the whole
window: batch x seq_len a call, the calls back to back."""

from bench_port.readers import tokens_per_s as read  # noqa: F401
