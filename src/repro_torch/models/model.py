"""Model facade: family registry + uniform loss/prefill/decode interface
(counterpart of :mod:`repro.models.model`).

``Model`` is an ``nn.Module`` whose parameters mirror the reference's
pytree (``layers.attn.wq`` is ``params["layers"]["attn"]["wq"]``); its
methods are the reference facade's without the ``params`` argument:

  loss(batch)                      -> scalar
  prefill(batch)                   -> last-position logits (B, 1, V)
  init_cache(batch, max_len)       -> decode cache (dict of tensors)
  decode_step(cache, tokens, cur_len, inplace=False) -> (logits, cache)
  input_specs(shape)               -> {name: meta tensor} for a named shape

Batches are dicts of tensors or arrays; they are moved to the model's
device.  The parameters have ``requires_grad`` off, as every serving path
wants them; training turns it on (``model.requires_grad_(True)`` in
:func:`repro_torch.train.build_train_step`), and then ``cfg.remat``
applies in every layer stack (:func:`repro_torch.models.transformer.
remat_call`).
"""
from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def family_module(cfg: ModelConfig) -> ModuleType:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return transformer
    if fam == "ssm":
        return ssm
    if fam == "hybrid":
        return hybrid
    if fam == "encdec":
        return encdec
    raise ValueError(f"unknown family {fam}")


class _Tree(nn.Module):
    """A nested dict of tensors as modules and (frozen) parameters."""

    def __init__(self, tree: Dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _Tree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def as_dict(self) -> Dict:
        out = {name: p for name, p in self._parameters.items()}
        out.update((name, m.as_dict()) for name, m in self._modules.items())
        return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, params: Dict):
        super().__init__()
        self.cfg = cfg
        self.weights = _Tree(params)

    @property
    def _mod(self) -> ModuleType:
        return family_module(self.cfg)

    @property
    def params(self) -> Dict:
        """The parameters as the reference's nested dict."""
        return self.weights.as_dict()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _inputs(self, batch: Dict) -> Dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    # ---------------- core API ---------------- #

    def loss(self, batch) -> torch.Tensor:
        return self._mod.loss_fn(self.params, self.cfg, self._inputs(batch))

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        if self.cfg.family == "ssm":
            return ssm.init_ssm_cache(self.cfg, batch, self.cfg.n_layers,
                                      device=self.device)
        return self._mod.init_cache(self.cfg, batch, max_len, dtype,
                                    self.device)

    def decode_step(self, cache, tokens, cur_len, inplace: bool = False):
        """One decode step; ``inplace`` writes the new cache rows into
        ``cache``'s own tensors and returns ``cache`` (the serving graph
        engine's decode: its buffers stay put), bit for bit the
        out-of-place result."""
        tokens = torch.as_tensor(tokens, device=self.device)
        cur_len = torch.as_tensor(cur_len, device=self.device)
        return self._mod.decode_step(self.params, self.cfg, cache, tokens,
                                     cur_len, inplace=inplace)

    def prefill(self, batch):
        """Inference prefill: full-sequence forward, LAST-position logits
        (the head is never evaluated on earlier positions, as in a serving
        engine)."""
        return self.logits(batch, last_only=True)

    def logits(self, batch, last_only: bool = False) -> torch.Tensor:
        """Next-token logits of the full-sequence forward, at every
        position or (``last_only``) the last: the forward that decode is
        held to (``tests/test_decode_parity.py``)."""
        cfg, params = self.cfg, self.params
        batch = self._inputs(batch)
        if cfg.family == "encdec":
            enc = encdec.encode(params, cfg,
                                batch["frames"].to(L.torch_dtype(
                                    cfg.param_dtype)))
            hidden = encdec.decode_train(params, cfg, batch["tokens"], enc)
        else:
            x = transformer.inputs_embedded(params, cfg, batch)
            positions = torch.arange(x.shape[1], device=x.device)
            if cfg.family == "hybrid":
                hidden = hybrid.forward(params, cfg, x, positions)
            elif cfg.family == "ssm":
                hidden = ssm.forward(params, cfg, x)
            else:
                hidden = transformer.forward(params, cfg, x, positions)
        if last_only:
            hidden = hidden[:, -1:, :]
        return transformer.logits_fn(params, cfg, hidden)

    # ---------------- dry-run input specs ---------------- #

    def input_specs(self, shape) -> Dict[str, torch.Tensor]:
        """Meta-device stand-ins (shape and dtype, no storage) for every
        model input of a cell: the counterpart of ``ShapeDtypeStruct``."""
        spec = SHAPES[shape] if isinstance(shape, str) else shape
        cfg = self.cfg
        b, s = spec.global_batch, spec.seq_len

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        i32, bf16 = torch.int32, torch.bfloat16
        if spec.kind in ("train", "prefill"):
            if cfg.family == "encdec":
                return {"frames": meta((b, s, cfg.d_model), bf16),
                        "tokens": meta((b, s), i32),
                        "labels": meta((b, s), i32)}
            if cfg.frontend in ("audio", "patch"):
                return {"embeddings": meta((b, s, cfg.d_model), bf16),
                        "labels": meta((b, s), i32)}
            return {"tokens": meta((b, s), i32), "labels": meta((b, s), i32)}
        # decode: one new token against a cache of length seq_len
        if cfg.frontend in ("audio", "patch") and cfg.family != "encdec":
            tok = meta((b, 1, cfg.d_model), bf16)
        else:
            tok = meta((b, 1), i32)
        return {"tokens": tok, "cur_len": meta((), i32)}

    def supports_shape(self, shape: str) -> bool:
        """long_500k requires sub-quadratic sequence mixing (run for
        SSM/hybrid, skip for pure full-attention archs)."""
        if shape != "long_500k":
            return True
        return self.cfg.family in ("ssm", "hybrid")


def init_params(cfg: ModelConfig, gen: Optional[torch.Generator],
                device) -> Dict:
    """The family's parameter tree drawn from ``gen`` on ``device``; on the
    ``meta`` device (``gen`` may be None) its layout alone."""
    return family_module(cfg).init_params(gen, cfg, device)


def build(cfg: ModelConfig, device: DeviceLike = None,
          seed: int = 0) -> Model:
    """The model with parameters drawn from ``seed`` by a generator on
    ``device`` (``None``: the card; raises without one unless ``"cpu"`` is
    asked).  The CPU and the card draw different numbers from one seed:
    to hold the card to the CPU, build on the CPU and move with ``.to``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, init_params(cfg, gen, dev))
