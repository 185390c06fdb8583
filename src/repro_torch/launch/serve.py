"""Batched serving: prefill + greedy decode with a KV cache on one
device, the port of ``repro.launch.serve``::

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --batch 4 --prompt-len 64 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \
      --smoke --device cpu

``--arch`` takes any id of :data:`repro_torch.configs.ARCHS`: the dense
smollm-360m, phi3-medium-14b, h2o-danube-3-4b and gemma-7b, the moe
mixtral-8x7b and phi3.5-moe-42b-a6.6b, the ssm falcon-mamba-7b, the
hybrid jamba-1.5-large-398b, the vlm internvl2-26b and the encdec
whisper-large-v3.  One prefill for the
whole batch, then shared decode steps.  On the card the prefill's
attention (whisper's: the encoder's, non-causal) is the port's Hopper
flash-attention kernel, ``flash_fwd_hopper`` (head_dim 64, 120, 128 and
gemma's 256), and the selective scan of falcon-mamba-7b's and jamba's
Mamba layers the Hopper scan kernel; the MoE layers' dispatch and experts are plain products, as in
the reference; decode runs no kernel of the port's own.

The vlm and encdec families take extra inputs (``extra``): the image
prefix ``patch_embeds`` (B, num_patches, d) or the audio ``frames`` (B,
n_frames, d), stubs of their frontends drawn from the seed as the
reference's ``main`` draws them.  The positions are the model's own
(ROADMAP.md queue C #20): vlm decodes after the prefix and the prompt,
at ``num_patches + P + i``; encdec decodes after its BOS token, at ``1 +
i``, with a self cache of ``gen_len`` and the prompt's tokens unused.
The reference's launcher decodes every family at ``P + i``.

On a ("data", "model") device mesh (``mesh`` and ``rules``, one of the
rule sets of :mod:`repro_torch.distributed.sharding`) the weights are
placed on the mesh over their own storage and the cache beside them, and
the prefill and the decode steps run inside the rules' sharding context:
every kernel on its rank's heads or channels, the tokens the same on every
rank.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..models import Model
from ..train.step import make_serve_steps

__all__ = ["decode_span", "serve_batch", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_span(cfg, prompt_len: int, gen_len: int) -> tuple[int, int]:
    """(the cache's length, the position of the first decode step) for
    ``gen_len`` tokens after a prompt of ``prompt_len``: the vlm's image
    prefix comes before the prompt, and encdec's decoder starts at its
    BOS token, position 0, whatever the prompt."""
    if cfg.family == "encdec":
        return gen_len, 1
    start = prompt_len + (cfg.num_patches if cfg.family == "vlm" else 0)
    return start + gen_len, start


def serve_batch(
    model: Model,
    prompts: np.ndarray,  # (B, P) int32
    gen_len: int,
    *,
    extra: Optional[dict] = None,
    params=None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    timings: Optional[dict] = None,
    mesh=None,
    rules=None,
    logits_out: Optional[list] = None,
) -> np.ndarray:
    """Greedy continuations (B, gen_len) of ``prompts``.

    ``extra`` holds the vlm's ``patch_embeds`` or encdec's ``frames`` as
    numpy arrays, cast to the compute type on the way in.  ``params`` is
    the model's module (e.g. weights carried over from the JAX package by
    :func:`repro_torch.convert.lm_from_jax`); without it the weights are
    drawn by ``model.init(generator)``.  ``timings``, when given,
    receives ``prefill_s`` (to the first token on the host), ``decode_s``
    and ``decode_steps``: host clocks around work that ends in a
    synchronise.  ``mesh`` (a ``DeviceMesh`` with "data" and "model"
    dims) and ``rules``: the tensor- and expert-parallel serving path
    (``params`` placed by :func:`~repro_torch.distributed.sharding.distribute_params`
    in place where they are not DTensors yet).  ``logits_out``, when
    given, receives each step's whole logits (B, vocab), the prefill's
    first.
    """
    device = torch.device(device)
    B, P = prompts.shape
    if params is None:
        params = model.init(generator=generator, device=device)
    prefill_step, decode_step = make_serve_steps(model)
    max_len, start = decode_span(model.cfg, P, gen_len)
    cache = model.init_cache(B, max_len=max_len, device=device)
    context = contextlib.nullcontext()
    if mesh is not None:
        from ..distributed.context import sharding_context
        from ..distributed.sharding import distribute_cache, distribute_params

        if not any(hasattr(p, "device_mesh") for p in params.parameters()):
            distribute_params(model, params, rules, mesh)
        cache = distribute_cache(model, cache, rules, mesh)
        context = sharding_context(mesh, rules)
    batch = {"tokens": torch.from_numpy(np.asarray(prompts, np.int64)).to(device)}
    cd = getattr(torch, model.cfg.compute_dtype)
    for name, value in (extra or {}).items():
        batch[name] = torch.from_numpy(np.asarray(value, np.float32)).to(device=device, dtype=cd)
    _sync(device)
    with context:
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, batch, cache)
        tok = logits.argmax(dim=-1).to(torch.int32)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        if logits_out is not None:
            logits_out.append(logits)

        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen_len - 1):
            tok, logits, cache = decode_step(params, tok, cache, start + i)
            out.append(tok)
            if logits_out is not None:
                logits_out.append(logits)
        toks = torch.stack(out, dim=1).cpu().numpy()  # synchronises
        decode_s = time.perf_counter() - t0
    if timings is not None:
        timings.update(prefill_s=prefill_s, decode_s=decode_s, decode_steps=gen_len - 1)
    print(f"[serve] B={B} prefill({P} tok): {prefill_s*1e3:.1f}ms, "
          f"decode {gen_len-1} steps: {decode_s*1e3:.1f}ms "
          f"({(gen_len-1)*B/max(decode_s,1e-9):.1f} tok/s) on {device}")
    return toks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = rng.normal(
            0, 1, (args.batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            0, 1, (args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)
    toks = serve_batch(model, prompts, args.gen, extra=extra, device=args.device)
    print(f"[serve] generated shape {toks.shape}; first row: {toks[0][:16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
