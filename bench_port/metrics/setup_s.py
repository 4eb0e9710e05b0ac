"""Seconds from the start of the process to the start of the window:
import, weights, quantization, kernel build and load, graph warm-up."""


def read(ctx):
    return ctx.setup_s
