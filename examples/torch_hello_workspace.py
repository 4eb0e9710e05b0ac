"""End-to-end hello, on the PyTorch port: the coordinator pipeline on a tiny
model.

The PyTorch twin of `examples/hello_workspace.py`: tokenize -> quantize ->
dedup-store -> route -> index (`process_model`), then prefill, generate and
diffusion-sample, with the store in a temporary directory.

Run: python examples/torch_hello_workspace.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from diffusion_llm_rs_tpu_torch import DiffusionConfig, SystemConfig
from diffusion_llm_rs_tpu_torch.engine import Engine


def main(device="cuda"):
    cfg = DiffusionConfig.tiny(vocab_size=512)
    with tempfile.TemporaryDirectory() as tmp:
        engine = Engine(config=cfg, system_config=SystemConfig(
            ssd_path=os.path.join(tmp, "store.bin")), device=device)

        stats = engine.process_model(
            "the quick brown fox jumps over the lazy dog")
        print("process_model:", stats)

        n = engine.prefill("diffusion language models on TPU")
        print(f"prefilled {n} tokens")

        text = engine.generate("the quick", max_length=8)
        print("generate:", repr(text))

        samples = engine.sample(batch_size=1, seq_len=8, num_steps=10)
        print("diffusion sample:", repr(samples[0]))
        out = engine.stats()
        print("engine stats:", out)
        return dict(process_model=stats, prefilled=n, stats=out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
