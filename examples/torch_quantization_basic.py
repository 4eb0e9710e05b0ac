"""Quantization library walkthrough, on the PyTorch port.

The PyTorch twin of `examples/quantization_basic.py`: round-to-nearest
quantization at 8/4/2/1 bits, calibration, salience scores and bit
allocation, and the compressed ANN index, over the same seeded data.

Run: python examples/torch_quantization_basic.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from diffusion_llm_rs_tpu_torch import quant
from diffusion_llm_rs_tpu_torch.cache.salience import SalienceEngine
from diffusion_llm_rs_tpu_torch.index.anns import FusionANNS


def main(device="cuda"):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 128))).to(
        device=device, dtype=torch.float32)
    for bits in (8, 4, 2, 1):
        qt = quant.quantize(x, bits)
        err = float(torch.mean(torch.abs(qt.dequantize() - x)))
        print(f"int{bits}: ratio {qt.compression_ratio():.1f}x, "
              f"mean|err| {err:.4f}")

    calib = quant.CalibrationData()
    calib.update(x)
    p = calib.compute_params(8, symmetric=False)
    print(f"calibrated: scale={p.scale:.5f} zp={p.zero_point}")

    sal = SalienceEngine()
    scores = sal.calculate("the quick brown fox jumps over the lazy dog")
    print("salience('the'):", scores["the"])
    bits = sal.allocate_bits(np.array([9.0, 1.0, 5.0, 0.1]), budget_bits=4)
    print("salience-driven bit allocation:", bits.tolist())

    ann = FusionANNS(embedding_dim=128, num_centroids=4, device=device)
    ann.index_vectors([f"v{i}" for i in range(64)], x.cpu().numpy())
    hits = ann.search(x[3].cpu().numpy(), k=3)
    print("ANN top-3 for v3:", hits)
    return dict(scores=scores, bits=bits, hits=hits, calibrated=p)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
