"""Generated tokens a second of the server over the whole window: each
slot-step of a request credits seq_len / num_steps tokens, so requests in
flight at either edge count for the steps they ran in the window."""

from bench_port.readers import tokens_per_s as read  # noqa: F401
