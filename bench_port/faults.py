"""Faults planted under the timed path, to show that `correct` fails on
them: each takes a `patch(obj, name, value)` (`setattr`, or pytest's
`monkeypatch.setattr`) and breaks the program where it produces its
result. `python3 -m bench_port.calibrate --fault <name>` reads one at a
cell's own size; the benchmark's own runs never plant one."""

from __future__ import annotations


def state_unchanged(patch) -> None:
    """Every denoise step returns its input: the serving step and the
    sampler's step both take `p_sample` from their module."""
    from diffusion_llm_rs_tpu_torch import serving
    from diffusion_llm_rs_tpu_torch.models import diffusion

    def same(schedule, x_t, t, eps_pred, generator=None, noise=None):
        return x_t + 0.0 * eps_pred
    patch(serving, "p_sample", same)
    patch(diffusion, "p_sample", same)


def token_altered(patch) -> None:
    """The readout serves the next token id at one position."""
    from diffusion_llm_rs_tpu_torch.models import denoiser as dn
    real = dn.decode_tokens

    def altered(params, x):
        tok = real(params, x).clone()
        tok[..., 3] = (tok[..., 3] + 1) % params["tok_embed"].shape[0]
        return tok
    patch(dn, "decode_tokens", altered)


FAULTS = {"state_unchanged": state_unchanged, "token_altered": token_altered}
