#!/usr/bin/env python3
"""Count the instructions a logit in the batched paged-attention kernels'
page loop, from their SASS, and the issue floor that count sets.

    python3 scripts/paged_sass.py

Needs nvcc and cuobjdump (the CUDA toolkit) and an NVIDIA GPU (for the
SM count and clock). It builds csrc/batched_paged_attention.cu and
csrc/paged_attention_a8.cu as `diffusion_llm_rs_tpu_torch.ops._build` does,
from a copy of the sources in which a tile's masked softmax is compiled out
(`if (valid < PT)` -> `if (false)`), so the page loop holds only the path a
full page runs. For each instance (bf16 / int8, head width, tile) it finds
the page loop -- the longest backward branch of the consumers -- counts its
instructions by kind and divides by the logits a consumer thread handles a
page (PT / 2): the fold of o, the products and the barrier waits are spread
over them. The floor: logits x instructions / 32 lanes over 4 warp
schedulers x SMs x the SM clock (nvidia-smi clocks.max.sm), at one warp
instruction a scheduler a clock.
"""

import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from diffusion_llm_rs_tpu_torch.ops import _build  # noqa: E402

# the serve_paged shape: B = 2, H = 12, Sq = Skv = 4096
LOGITS = 2 * 12 * 4096 * 4096
KINDS = {"FP32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FCHK"),
         "MUFU": ("MUFU",), "CONVERT": ("I2F", "F2I", "F2F", "F2FP"),
         "INT": ("IADD3", "IMAD", "LOP3", "SHF", "PRMT", "ISETP", "SEL",
                 "LEA", "IABS", "IMNMX"),
         "MEMORY": ("LDS", "STS", "LDG", "STG", "LDC", "LDSM"),
         "SHUFFLE": ("SHFL",), "TENSOR": ("HGMMA", "IGMMA", "WARPGROUP")}


def kind(op):
    base = op.split(".")[0]
    for k, ops in KINDS.items():
        if base in ops:
            return k
    return "OTHER"


def page_loop(sass):
    """Instructions of the longest backward branch's body."""
    lines = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    best = None
    for addr, ins in lines:
        m = re.search(r"\bBRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            span = (int(m.group(1), 16), addr)
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    return [ins for addr, ins in lines if best[0] <= addr <= best[1]]


def main():
    import torch
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tmp = Path(tempfile.mkdtemp(prefix="paged_sass_", dir=ROOT / "build"))
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp / f.name)
    flash = (tmp / "paged_flash.cuh").read_text()
    flash = flash.replace("if (valid < PT)", "if (false)")
    (tmp / "paged_flash.cuh").write_text(flash)
    _build.CSRC, _build.BUILD_DIR = tmp, tmp / "out"
    targets = _build.build(("batched_paged_attention", "paged_attention_a8"))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name, so in targets.items():
        sass = subprocess.run([cuobjdump, "-sass", str(so)],
                              capture_output=True, text=True).stdout
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            m = re.match(r"\S*paged_flash_kernelILb(\d)ELi(\d+)ELi(\d+)E", fn)
            if not m:
                continue
            a8, D, PT = m.group(1) == "1", int(m.group(2)), int(m.group(3))
            body = page_loop(fn)
            counts = collections.Counter(kind(i.split()[0] if not i.startswith("@")
                                              else i.split()[1]) for i in body)
            per_logit = len(body) / (PT // 2)
            floor_ms = LOGITS * per_logit / 32 / (4 * sms * clock_mhz * 1e6) * 1e3
            key = f"{'int8' if a8 else 'bf16'} D={D} PT={PT}"
            out[key] = dict(loop_instructions=len(body),
                            per_logit=round(per_logit, 2),
                            by_kind={k: round(v / (PT // 2), 2)
                                     for k, v in sorted(counts.items())},
                            issue_floor_ms_serve_paged=round(floor_ms, 4))
            print(f"{key}: {len(body)} instructions in the page loop, "
                  f"{per_logit:.2f} a logit {out[key]['by_kind']}; issue "
                  f"floor at serve_paged {floor_ms:.4f} ms", flush=True)
    print(json.dumps(dict(sms=sms, clock_mhz=clock_mhz, kernels=out)))
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
