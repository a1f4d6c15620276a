"""Serving entry point: decode-serving and sweep-serving behind one CLI.

Two modes, dispatched on the first argument:

* ``decode`` — the batched LLM serving driver: prefill + greedy decode
  loop with KV cache (or recurrent state) over synthetic prompts;
  reports tokens/s and validates the cache path end to end.  The block
  kinds of ``models.model.KINDS``, every config of ``configs/archs.py``
  (the dense decoders, qwen2-vl with M-RoPE, the MoE ones, xLSTM,
  zamba2's Mamba-2 with its shared attention, the encoder-decoder): an
  encoder-decoder's encoder runs once on synthetic frame embeddings drawn
  after the prompts, as the reference draws them, and fills the
  cross-attention caches; qwen2-vl's prompt is text only, as the
  reference's CLI feeds it, rotated by M-RoPE at every position.

      PYTHONPATH=src python -m repro_torch.launch.serve decode \\
          --arch mistral-nemo-12b --batch 4 --prompt-len 64 --gen 32
      PYTHONPATH=src python -m repro_torch.launch.serve decode \\
          --arch zamba2-2.7b
      PYTHONPATH=src python -m repro_torch.launch.serve decode \\
          --arch gemma3-12b --smoke --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve decode \\
          --arch seamless-m4t-large-v2 --smoke --device cpu
      PYTHONPATH=src python -m repro_torch.launch.serve decode \\
          --arch qwen2-vl-7b --smoke --device cpu

* ``sweep`` — the persistent sweep server
  (:mod:`repro_torch.launch.sweep_serve`): accepts streaming (workload,
  arch, density, method, budget) queries over a local socket, coalesces
  same-signature queries into shared mega-batch rounds, streams
  best-so-far results, checkpoints populations and survives crashes.

      PYTHONPATH=src python -m repro_torch.launch.serve sweep \\
          --port 7333 --checkpoint-dir /tmp/sweeps --device-rounds 1
      PYTHONPATH=src python -m repro_torch.launch.serve sweep --device cpu

Bare flags (no mode word) select decode, as in the JAX package.  Both
modes run on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

MODES = ("decode", "sweep")

_USAGE = """\
usage: python -m repro_torch.launch.serve <mode> [mode options]

modes:
  decode   batched LLM serving driver (prefill + greedy decode loop);
           options: --arch --smoke --batch --prompt-len --gen --device
  sweep    persistent accelerator-search sweep server (query coalescing,
           checkpointed populations, crash recovery); options: --host
           --port --checkpoint-dir --checkpoint-every --max-restarts
           --no-warm-start --device-rounds --no-stack --device

`<mode> --help` shows that mode's full options.  Bare flags (no mode
word) run decode.
"""


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in MODES:
        if argv[0] == "sweep":
            from . import sweep_serve
            return sweep_serve.main(argv[1:])
        return decode_main(argv[1:])
    if argv[:1] in (["-h"], ["--help"]):
        print(_USAGE)
        return 0
    return decode_main(argv)        # bare flags mean decode


def make_inputs(vocab_size: int, batch: int, prompt_len: int,
                d_model: int = 0):
    """``(prompts, enc_embeds)``: the synthetic prompts [batch,
    prompt_len] from ``np.random.default_rng(0)``, and, with a
    ``d_model``, an encoder's input [batch, prompt_len, d_model] drawn
    next from the same generator, rounded to bf16 and scaled by bf16's
    0.02 (``None`` without), as the reference's CLI draws both."""
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, vocab_size, (batch, prompt_len))
    if not d_model:
        return prompts, None
    enc = torch.from_numpy(rng.standard_normal((batch, prompt_len,
                                                d_model))).to(torch.bfloat16)
    return prompts, enc * torch.tensor(0.02, dtype=torch.bfloat16)


@torch.inference_mode()
def run_decode(model, prompts: torch.Tensor, gen: int,
               enc_embeds: Optional[torch.Tensor] = None) -> dict:
    """Step the prompts [B, P] through ``decode_step`` token by token
    (prefill), then decode ``gen`` tokens greedily, as the reference's
    loop does; ``enc_embeds`` [B, S_enc, d] runs an encoder-decoder's
    encoder once, into the cache, first.  Returns the generated tokens
    [B, gen] (numpy), the host seconds of both loops and those of the
    encoder's run (``encode_s``, ``None`` without ``enc_embeds``), each
    ended by a synchronise; the cache's making is in none of them."""
    from .steps import build_serve_step
    b, pl_ = prompts.shape
    dev = prompts.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cache = model.init_cache(b, pl_ + gen + 1)
    step = build_serve_step(model)
    encode_s = None
    if enc_embeds is not None:
        sync()
        t0 = time.perf_counter()
        model.encode_into(cache, enc_embeds)
        sync()
        encode_s = time.perf_counter() - t0

    sync()
    t0 = time.perf_counter()
    tok = prompts[:, 0:1]
    for i in range(pl_):
        logits = step(cache, tok, i)
        tok = prompts[:, i + 1:i + 2] if i + 1 < pl_ else \
            torch.argmax(logits[:, -1:], dim=-1)
    sync()
    prefill_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out_tokens = []
    for i in range(gen):
        logits = step(cache, tok, pl_ + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out_tokens.append(tok)
    tokens = torch.cat(out_tokens, dim=1).cpu().numpy()
    decode_s = time.perf_counter() - t0
    return dict(tokens=tokens, prefill_s=prefill_s, decode_s=decode_s,
                encode_s=encode_s)


def decode_main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve decode",
        description="Batched serving driver: prefill + greedy decode "
                    "loop with KV cache over synthetic prompts; reports "
                    "tokens/s.")
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the GPU; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    from ..configs import get_config, smoke_config
    from ..device import resolve_device
    from ..models.model import Model, unported

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    reason = unported(cfg)
    if reason:
        print(f"serve decode: {reason}", file=sys.stderr)
        return 2
    # the device first: no weights are built before it is known
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve decode: {e}", file=sys.stderr)
        return 2
    model = Model(cfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(0))
    b, pl_, g = args.batch, args.prompt_len, args.gen
    prompts, enc = make_inputs(cfg.vocab_size, b, pl_,
                               cfg.d_model if cfg.n_enc_layers else 0)
    res = run_decode(model, torch.from_numpy(prompts).to(device), g,
                     None if enc is None else enc.to(device))
    gen = res["tokens"]

    print(f"arch={cfg.name} batch={b} prompt={pl_} gen={g} device={device}")
    print(f"prefill: {pl_ * b / max(res['prefill_s'], 1e-9):.1f} tok/s   "
          f"decode: {g * b / max(res['decode_s'], 1e-9):.1f} tok/s")
    print(f"first generated rows: {gen[:2, :8].tolist()}")
    if gen.shape != (b, g) or not ((gen >= 0) & (gen < cfg.vocab_size)).all():
        print(f"serve decode: generated tokens of shape {gen.shape} out of "
              f"[0, {cfg.vocab_size})", file=sys.stderr)
        return 1
    print("serve ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
