"""Command-line entry point: ``python -m diffusion_llm_rs_tpu_torch <cmd>``.

Counterpart of `diffusion_llm_rs_tpu/__main__.py`, with the same
subcommands, flags and outputs:

  generate   greedy text continuation (the text on one line)
  sample     reverse-diffusion sampling (one text a line)
  ppl        denoising perplexity of a text (one JSON line)
  serve      continuous-batching throughput demo (one JSON line)
  quantize   weight quantization, optionally saved as a checkpoint that
             both packages load (one JSON line)
  ingest     the `process_model` pipeline on a text, then the engine's
             stats (one JSON line, keys sorted)

All commands default to the shipped pretrained anchor
(`Engine.from_pretrained()`); `--random-init` builds a random model.
`--device` (default `cuda`) takes the place of JAX's `--platform`; the CPU
runs the kernels' plain versions.
"""

import argparse
import json
import os
import sys
import time


def _add_engine_args(p):
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint stem (<stem>.npz/.json); default: the "
                        "shipped quality anchor")
    p.add_argument("--random-init", action="store_true",
                   help="random-init model instead of a checkpoint")
    p.add_argument("--bits", type=int, default=None, choices=(1, 2, 4, 8),
                   help="weight-quantize to this many bits before running")
    p.add_argument("--quant-method", default="int",
                   choices=("int", "gptq", "fp8"))
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")


def _build_engine(args):
    from diffusion_llm_rs_tpu_torch.engine import Engine
    if args.random_init:
        eng = Engine(device=args.device)
    else:
        eng = Engine.from_pretrained(args.checkpoint, device=args.device)
    if args.bits or args.quant_method == "fp8":
        # fp8 stores 8-bit floats whatever --bits says (the flag is the int
        # grid width); a nominal 8 keeps the call unambiguous
        eng.quantize_weights(args.bits or 8, method=args.quant_method)
    return eng


def _param_bytes(params) -> int:
    """Bytes of every stored array, counted as the JAX package's CLI counts
    its pytree leaves (a quantized leaf's data and sidecars)."""
    import torch

    from diffusion_llm_rs_tpu_torch.quant.core import tree_leaves

    total = 0
    for leaf in tree_leaves(params):
        arrays = [leaf] if isinstance(leaf, torch.Tensor) else [
            getattr(leaf, name, None)
            for name in ("data", "scale", "zero_point", "col_scale")]
        total += sum(a.numel() * a.element_size() for a in arrays
                     if isinstance(a, torch.Tensor))
    return total


def cmd_generate(args):
    eng = _build_engine(args)
    print(eng.generate(args.prompt, max_length=args.max_length))


def cmd_sample(args):
    eng = _build_engine(args)
    texts = eng.sample(batch_size=args.batch, seq_len=args.seq_len,
                       num_steps=args.steps, seed=args.seed,
                       salience_routing=args.salience)
    for t in texts:
        print(t)


def cmd_ppl(args):
    eng = _build_engine(args)
    text = args.text or sys.stdin.read()
    ppl = eng.denoising_perplexity(text, t=args.t)
    # the stored width (a quantized --checkpoint or fp8 differs from --bits)
    print(json.dumps({"perplexity": round(float(ppl), 4), "t": args.t,
                      "bits": int(eng.stats()["weight_bits"]),
                      "method": args.quant_method}))


def cmd_ingest(args):
    eng = _build_engine(args)
    text = open(args.file).read() if args.file else sys.stdin.read()
    stats = eng.process_model(text, model_id=args.model_id)
    stats.update(eng.stats())
    print(json.dumps({k: v for k, v in sorted(stats.items())}, default=float))


def cmd_serve(args):
    eng = _build_engine(args)
    from diffusion_llm_rs_tpu_torch.serving import (PagedContinuousBatcher,
                                                    Request)
    b = PagedContinuousBatcher(eng.params, eng.config, eng.schedule,
                               num_slots=args.slots, seq_len=args.seq_len,
                               page_size=args.page_size,
                               salience_routing=args.salience,
                               keep_embeddings=False, device=eng.device)
    for i in range(args.requests):
        b.submit(Request(f"r{i}", seq_len=args.seq_len, num_steps=args.steps))
    t0 = time.perf_counter()
    done = b.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(c.tokens.size for c in done)
    out = {"requests": len(done), "gen_tokens": int(toks),
           "seconds": round(dt, 3), "tokens_per_sec": round(toks / dt, 1)}
    out.update({k: round(float(v), 4) for k, v in b.stats().items()})
    print(json.dumps(out))


def cmd_quantize(args):
    # the flag contract, before the checkpoint loads
    if not args.bits and args.quant_method != "fp8":
        raise SystemExit("quantize requires --bits (unless --quant-method fp8)")
    eng = _build_engine(args)
    if args.out:
        from diffusion_llm_rs_tpu_torch.utils.serialization import save_checkpoint
        # the anchor's metadata (config + tokenizer), so the stem loads back
        # through Engine.from_pretrained / --checkpoint in both packages
        cfg = eng.config
        tok_name = os.path.basename(args.out) + ".tok.json"
        meta = {
            "bits": args.bits or 8, "method": args.quant_method,
            "config": {"num_timesteps": cfg.num_timesteps,
                       "hidden_size": cfg.hidden_size,
                       "num_layers": cfg.num_layers,
                       "num_attention_heads": cfg.num_attention_heads,
                       "vocab_size": cfg.vocab_size,
                       "max_sequence_length": cfg.max_sequence_length,
                       "dtype": cfg.dtype},
            "tokenizer": tok_name,
        }
        save_checkpoint(args.out, eng.params, meta)
        eng.tokenizer.save(os.path.join(
            os.path.dirname(os.path.abspath(args.out)), tok_name))
    print(json.dumps({"bits": args.bits or 8, "method": args.quant_method,
                      "param_bytes": _param_bytes(eng.params),
                      "saved": args.out or None}))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="diffusion_llm_rs_tpu_torch",
        description="quantized diffusion-LM inference engine on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("generate", help="greedy text continuation")
    _add_engine_args(p)
    p.add_argument("--prompt", required=True)
    p.add_argument("--max-length", type=int, default=16)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("sample", help="reverse-diffusion sampling")
    _add_engine_args(p)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--salience", action="store_true")
    p.set_defaults(fn=cmd_sample)

    p = sub.add_parser("ppl", help="denoising perplexity of a text")
    _add_engine_args(p)
    p.add_argument("--text", default=None, help="default: read stdin")
    p.add_argument("--t", type=int, default=10)
    p.set_defaults(fn=cmd_ppl)

    p = sub.add_parser("ingest", help="process_model pipeline on a text")
    _add_engine_args(p)
    p.add_argument("--file", default=None, help="default: read stdin")
    p.add_argument("--model-id", default="model")
    p.set_defaults(fn=cmd_ingest)

    p = sub.add_parser("serve", help="continuous-batching throughput demo")
    _add_engine_args(p)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--salience", action="store_true")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("quantize", help="quantize weights; optionally save")
    _add_engine_args(p)
    p.add_argument("--out", default=None, help="checkpoint stem to write")
    p.set_defaults(fn=cmd_quantize)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
