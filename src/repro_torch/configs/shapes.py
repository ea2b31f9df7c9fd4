"""The dry-run's input-shape cells and their input specs (port of
``repro/configs/shapes.py``).

  train_4k     seq 4096,    global_batch 256  -> train_step
  prefill_32k  seq 32768,   global_batch 32   -> prefill
  decode_32k   ctx 32768,   global_batch 128  -> serve_step (1 token + cache)
  long_500k    ctx 524288,  global_batch 1    -> serve_step; sub-quadratic
                                                  archs only (DESIGN.md §4)

Modality frontends are stubs: the specs give the embeddings and position
ids a frontend would produce (Whisper's mel frames as ``enc_embeds``,
Qwen2-VL's (3, B, S) mrope ``positions``).  Where the reference returns
``jax.ShapeDtypeStruct``s, ``input_specs`` returns ``(shape, dtype)``
pairs, or with ``device`` empty tensors there (``"meta"``, or a device
under a ``FakeTensorMode``, which allocates nothing).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (the reference's skip)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("SKIP: pure full-attention arch — 500k decode has no "
                       "sub-quadratic path (DESIGN.md §4)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: str,
                activation_dtype=torch.bfloat16, *, batch: int | None = None,
                device=None) -> dict[str, Any]:
    """The cell's model inputs: for "train" a ``loss_fn`` batch, for
    "prefill" the prefill inputs, for "decode" one token per sequence and
    ``pos`` (the caches are built by the dry-run).  ``batch`` replaces the
    cell's global batch (a data-parallel rank's share).  Without
    ``device``: name -> (shape, dtype); with it: name -> an empty tensor."""
    cell = SHAPES[shape]
    b, s = batch or cell.global_batch, cell.seq_len
    specs: dict[str, Any] = {}
    if cell.kind in ("train", "prefill"):
        n = s + 1 if cell.kind == "train" else s
        specs["tokens"] = ((b, n), torch.int32)
        if cfg.pos == "mrope":
            specs["positions"] = ((3, b, n), torch.int32)
        if cfg.enc_dec:
            specs["enc_embeds"] = ((b, cfg.n_audio_ctx, cfg.d_model),
                                   activation_dtype)
    else:  # decode
        specs["tokens"] = ((b, 1), torch.int32)
        specs["pos"] = ((), torch.int32)
    if device is None:
        return specs
    return {k: torch.empty(shp, dtype=dt, device=device)
            for k, (shp, dt) in specs.items()}


def concrete_inputs(cfg: ModelConfig, shape: str,
                    generator: torch.Generator | None = None,
                    activation_dtype=torch.float32, *,
                    batch: int | None = None, device="cpu") -> dict[str, Any]:
    """Concrete batches matching ``input_specs`` (smoke tests), drawn from
    ``generator`` (seeded 0 on ``device`` if None): tokens uniform over
    the vocabulary, ``pos`` 0, mrope ``positions`` 0..S-1 on every
    stream, float inputs standard normal."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    out = {}
    for k, (shp, dt) in input_specs(cfg, shape, activation_dtype,
                                    batch=batch).items():
        if dt == torch.int32:
            if k == "pos":
                out[k] = torch.zeros((), dtype=torch.int32, device=device)
            elif k == "positions":
                out[k] = torch.arange(shp[-1], dtype=torch.int32,
                                      device=device).expand(shp).clone()
            else:
                out[k] = torch.randint(0, cfg.vocab, shp, generator=generator,
                                       dtype=torch.int32, device=device)
        else:
            out[k] = torch.randn(shp, generator=generator, device=device,
                                 dtype=torch.float32).to(dt)
    return out
