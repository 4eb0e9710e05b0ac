"""Seed streams: every input of a run is drawn from `--seed` through `mix`.

`mix(seed, *labels)` hashes a run's seed and a label path ("weights",
("step", 17), ...) into one 63-bit seed, so a stream can be drawn again by
anyone who knows the run's seed and the label, in any order: the reference
draws each request's noise again after the window from the same labels.
"""

from __future__ import annotations

import hashlib

import torch


def mix(seed: int, *labels) -> int:
    """A 63-bit seed for the stream `labels` of the run seeded `seed`."""
    text = repr((int(seed),) + tuple(labels)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") >> 1


class Draws:
    """Standard normals in f32, each draw from a generator seeded by its
    label: `draw(labels, shape)` gives the same tensor for the same labels
    and shape on the same kind of device."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)

    def draw(self, labels, shape) -> torch.Tensor:
        self.generator.manual_seed(mix(self.seed, *labels))
        return torch.randn(tuple(shape), generator=self.generator,
                           dtype=torch.float32, device=self.device)


class ServingNoise(Draws):
    """The noise source a batcher takes (`admission(shape)`, `step(shape)`):
    admission wave i draws ("admission", i), step draw j draws ("step", j).
    A request admitted in wave i into slot s, whose first step is step draw
    j, starts from row s of admission draw i and takes row s of step draws
    j .. j + num_steps - 1: every active slot steps at every step.
    `on_admission(wave, first_step)` runs as the wave is drawn, while the
    batcher's `slot_request` and `t` show the admitted requests."""

    def __init__(self, seed: int, device, on_admission=None):
        super().__init__(seed, device)
        self.waves = 0
        self.steps = 0
        self.on_admission = on_admission

    def admission(self, shape) -> torch.Tensor:
        if self.on_admission is not None:
            self.on_admission(self.waves, self.steps)
        z = self.draw(("admission", self.waves), shape)
        self.waves += 1
        return z

    def step(self, shape) -> torch.Tensor:
        z = self.draw(("step", self.steps), shape)
        self.steps += 1
        return z
