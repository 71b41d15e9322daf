"""BERT encoder family (bert-base default; PyTorch port of
tpuserve/models/bert.py).

Pure-function encoder over a flat param dict: wordpiece/position/type
embeddings, post-LN transformer blocks, GELU FFN (the tanh approximation,
jax.nn.gelu's default), pooler + classifier. All matmul weights are 2-D
and quantize through the standard predicate: at int8 each one runs on the
Hopper quant-matmul (6 a layer, then pooler and classifier). Attention is
plain torch ops, as it is XLA in the JAX package: scores in f32 with an
additive -1e30 mask, probs cast to v's dtype before P @ V.

Inputs: input_ids int32 [B, L], optional attention_mask int32 [B, L]
(type ids are always 0). Outputs: logits [B, num_labels] and the pooled
[B, D], both f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from tpuserve_torch.models.layers import layer_norm, linear
from tpuserve_torch.models.registry import Architecture, register_architecture


@register_architecture("bert")
class Bert(Architecture):
    def _dims(self):
        mp = self.params_cfg
        return {
            "vocab_size": int(mp.get("vocab_size", 30522)),
            "dim": int(mp.get("dim", 768)),
            "n_layers": int(mp.get("n_layers", 12)),
            "n_heads": int(mp.get("n_heads", 12)),
            "ffn_dim": int(mp.get("ffn_dim", 3072)),
            "max_len": int(mp.get("max_len", 512)),
            "type_vocab": int(mp.get("type_vocab", 2)),
            "num_labels": int(mp.get("num_labels", 2)),
        }

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        d = self._dims()
        dev, bf16 = self.device, torch.bfloat16
        params: Dict[str, torch.Tensor] = {}

        def w(shape, std=0.02):
            return self._normal(generator, shape, std)

        def ones(n):
            return torch.ones((n,), dtype=bf16, device=dev)

        def zeros(n):
            return torch.zeros((n,), dtype=bf16, device=dev)

        params["embed/word"] = w((d["vocab_size"], d["dim"]))
        params["embed/position"] = w((d["max_len"], d["dim"]))
        params["embed/type"] = w((d["type_vocab"], d["dim"]))
        params["embed/ln/scale"] = ones(d["dim"])
        params["embed/ln/bias"] = zeros(d["dim"])
        for l in range(d["n_layers"]):
            pre = f"layers.{l}"
            for name, shape in [
                ("wq", (d["dim"], d["dim"])), ("wk", (d["dim"], d["dim"])),
                ("wv", (d["dim"], d["dim"])), ("wo", (d["dim"], d["dim"])),
                ("ffn_in", (d["dim"], d["ffn_dim"])), ("ffn_out", (d["ffn_dim"], d["dim"])),
            ]:
                params[f"{pre}/{name}/kernel"] = w(shape)
                params[f"{pre}/{name}/bias"] = zeros(shape[1])
            for ln in ("attn_ln", "ffn_ln"):
                params[f"{pre}/{ln}/scale"] = ones(d["dim"])
                params[f"{pre}/{ln}/bias"] = zeros(d["dim"])
        params["pooler/kernel"] = w((d["dim"], d["dim"]))
        params["pooler/bias"] = zeros(d["dim"])
        params["classifier/kernel"] = w((d["dim"], d["num_labels"]))
        params["classifier/bias"] = zeros(d["num_labels"])
        return params

    def apply(self, params: Dict, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        d = self._dims()
        out_name = self.config.outputs[0].name if self.config.outputs else "logits"
        ids = inputs.get("input_ids")
        if ids is None:
            raise ValueError("bert requires 'input_ids'")
        ids = torch.as_tensor(ids).to(device=self.device, dtype=torch.long)
        b, l = ids.shape
        mask = inputs.get("attention_mask")
        mask = (torch.ones((b, l), dtype=torch.int32, device=self.device) if mask is None
                else torch.as_tensor(mask).to(device=self.device, dtype=torch.int32))

        x = (params["embed/word"][ids]
             + params["embed/position"][:l][None, :, :]
             + params["embed/type"][0][None, None, :])
        x = layer_norm(params, "embed/ln", x, eps=1e-12)

        attn_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30)  # [B,1,1,L] f32
        h = d["dim"] // d["n_heads"]
        for layer in range(d["n_layers"]):
            pre = f"layers.{layer}"
            q = linear(params, f"{pre}/wq", x).reshape(b, l, d["n_heads"], h)
            k = linear(params, f"{pre}/wk", x).reshape(b, l, d["n_heads"], h)
            v = linear(params, f"{pre}/wv", x).reshape(b, l, d["n_heads"], h)
            scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
            scores = scores / math.sqrt(h) + attn_bias
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhlm,bmhd->blhd", probs.to(v.dtype), v).reshape(b, l, d["dim"])
            x = layer_norm(params, f"{pre}/attn_ln", x + linear(params, f"{pre}/wo", ctx),
                           eps=1e-12)
            y = torch.nn.functional.gelu(linear(params, f"{pre}/ffn_in", x).float(),
                                         approximate="tanh").to(x.dtype)
            x = layer_norm(params, f"{pre}/ffn_ln", x + linear(params, f"{pre}/ffn_out", y),
                           eps=1e-12)

        pooled = torch.tanh(linear(params, "pooler", x[:, 0, :]).float()).to(x.dtype)
        logits = linear(params, "classifier", pooled).float()
        return {out_name: logits, "pooled": pooled.float()}
